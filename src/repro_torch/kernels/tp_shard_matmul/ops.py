"""Wrapper of the TP-shard-selecting matmul (csrc/tp_shard_matmul.cu).

CPU and meta tensors take the plain version in ref.py; CUDA tensors launch
the kernel or raise. Modes: "col" and "row" select a column or row shard of a
(K, N) weight; "col_t" selects rows of a weight stored transposed, (N, K),
as the tied LM head reads the embedding's vocab rows.
``tp_shard_matmul.launches`` counts wrapper calls that launched: every call
launches one kernel, split-K reduced in the same launch (bf16 ``wgmma_mm``;
f32 ``skinny_mm`` at M <= 8 and ``fma_mm`` above). A call inside a CUDA
graph capture launches nothing: the graph's owner
(``core.tp_switch.ExecutableCache``) takes it back off the count and adds it
again at every replay. Under autograd (an input that requires grad) a call
goes through ``_ShardMatmul``, whose forward is the same launch and whose
backward's own launches count in ``tp_shard_matmul.backward_launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tp_shard_matmul.ref import tp_shard_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("tp_shard_matmul")
    fn = lib.tp_shard_matmul
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, p, ll, i, i, i, ll, i, i, i, p]
        fn.restype = i
        lib.tp_shard_matmul_scratch.argtypes = [i, i, i, i, i, ctypes.POINTER(ll), ctypes.POINTER(ll)]
        lib.tp_shard_matmul_scratch.restype = None
    return lib


_SCRATCH_TOO_SMALL = -1


def _grow_scratch(lib, device: torch.device, stream: int, m: int, n: int, k: int, dtype: int, trans: int):
    """The split-K workspace (bytes) and per-tile counters, grown to this call's need."""
    need_ws, need_cnt = ctypes.c_longlong(), ctypes.c_longlong()
    lib.tp_shard_matmul_scratch(m, n, k, dtype, trans, ctypes.byref(need_ws), ctypes.byref(need_cnt))
    return _build.scratch("tp_shard_matmul", device, stream, (need_ws.value, torch.uint8, need_cnt.value))


def tp_shard_matmul(
    x: torch.Tensor,
    w_store: torch.Tensor,
    offset: int,
    *,
    n_out: int,
    mode: str = "col",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """y = x @ (the shard of w_store selected at ``offset``).

    x: (M, K). col: w_store (K, N_store), takes columns offset..offset+n_out.
    row: w_store (K_store, n_out), takes rows offset..offset+K. col_t:
    w_store (N_store, K), takes rows offset..offset+n_out, transposed. Sums
    in f32; the output is ``out_dtype``, x's dtype by default (f32 for
    logits).
    """
    out_dtype = out_dtype or x.dtype
    if x.dim() != 2 or w_store.dim() != 2:
        raise ValueError(f"x and w_store must be 2-D, got {tuple(x.shape)} and {tuple(w_store.shape)}")
    if x.dtype not in _DTYPES or w_store.dtype != x.dtype:
        raise TypeError(f"x and w_store must share a dtype in {list(_DTYPES)}, got {x.dtype}, {w_store.dtype}")
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {x.dtype} or float32, got {out_dtype}")
    m, k = x.shape
    rows, cols = w_store.shape
    if mode == "col":
        if rows != k or not 0 <= offset <= cols - n_out:
            raise ValueError(f"col: x {tuple(x.shape)}, w_store {tuple(w_store.shape)}, offset {offset}, n_out {n_out}")
    elif mode == "row":
        if cols != n_out or not 0 <= offset <= rows - k:
            raise ValueError(f"row: x {tuple(x.shape)}, w_store {tuple(w_store.shape)}, offset {offset}, n_out {n_out}")
    elif mode == "col_t":
        if cols != k or not 0 <= offset <= rows - n_out:
            raise ValueError(f"col_t: x {tuple(x.shape)}, w_store {tuple(w_store.shape)}, offset {offset}, n_out {n_out}")
        if out_dtype != torch.float32:
            raise TypeError(f"col_t computes the tied head's logits: out_dtype must be float32, got {out_dtype}")
    else:
        raise ValueError(f"mode must be 'col', 'row' or 'col_t', got {mode!r}")

    if x.device.type in _build.PLAIN_DEVICES and w_store.device == x.device:
        return tp_shard_matmul_ref(x, w_store, offset, mode=mode, n_out=n_out, out_dtype=out_dtype)
    if x.device.type != "cuda" or w_store.device != x.device:
        raise ValueError(f"x and w_store must lie on one CUDA device, got {x.device} and {w_store.device}")
    if not (x.is_contiguous() and w_store.is_contiguous()):
        raise ValueError("x and w_store must be contiguous")
    if torch.is_grad_enabled() and (x.requires_grad or w_store.requires_grad):
        y = _ShardMatmul.apply(x, w_store, offset, n_out, mode, out_dtype)
    else:
        y = _launch(x, w_store, offset, n_out, mode, out_dtype)
    if y.numel() and k:
        tp_shard_matmul.launches += 1
    return y


def _launch(x: torch.Tensor, w_store: torch.Tensor, offset: int, n_out: int, mode: str,
            out_dtype: torch.dtype) -> torch.Tensor:
    """One launch of the kernel on checked CUDA tensors (see tp_shard_matmul);
    an empty product launches nothing."""
    m, k = x.shape
    cols = w_store.shape[1]
    y = torch.empty((m, n_out), dtype=out_dtype, device=x.device)
    if y.numel() == 0 or k == 0:
        return y.zero_()
    lib = _lib()
    dt = _DTYPES[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws, cnt = _build.scratch("tp_shard_matmul", x.device, stream)
    base = offset if mode == "col" else offset * cols
    w_ptr = w_store.data_ptr() + base * w_store.element_size()
    args = (x.data_ptr(), w_ptr, y.data_ptr())
    trans = int(mode == "col_t")
    tail = (m, n_out, k, cols, dt, int(out_dtype == torch.float32 and x.dtype != torch.float32), trans, stream)
    rc = _SCRATCH_TOO_SMALL
    if ws is not None:
        rc = lib.tp_shard_matmul(*args, ws.data_ptr(), ws.numel(), cnt.data_ptr(), cnt.numel(), *tail)
    if rc == _SCRATCH_TOO_SMALL:
        ws, cnt = _grow_scratch(lib, x.device, stream, m, n_out, k, dt, trans)
        rc = lib.tp_shard_matmul(*args, ws.data_ptr(), ws.numel(), cnt.data_ptr(), cnt.numel(), *tail)
    _build.check(lib, rc, "tp_shard_matmul")
    return y


def _shard(w_store: torch.Tensor, offset: int, width: int, mode: str) -> torch.Tensor:
    """The shard a call reads, as a view of the storage: (K, N) for col and
    row, (N, K) for col_t."""
    return w_store.narrow(1 if mode == "col" else 0, offset, width)


class _ShardMatmul(torch.autograd.Function):
    """The kernel under autograd, on CUDA tensors.

    Forward is one launch. Backward gives dX and the gradient of the whole
    storage tensor, zero but for the shard the call read. The reference's
    backward products come from XLA's autodiff, outside any Pallas kernel;
    here dX of a row call is a col_t launch over the same rows and dX of a
    col_t call a row launch (``tp_shard_matmul.backward_launches`` counts
    them), and the rest are ``torch.matmul`` on the shard's view, which
    needs TF32 off for f32. Sums are in f32; each gradient is cast to its
    input's dtype.
    """

    @staticmethod
    def forward(ctx, x, w_store, offset, n_out, mode, out_dtype):
        ctx.save_for_backward(x, w_store)
        ctx.conf = (offset, n_out, mode)
        return _launch(x, w_store, offset, n_out, mode, out_dtype)

    @staticmethod
    def backward(ctx, gy):
        x, w_store = ctx.saved_tensors
        offset, n_out, mode = ctx.conf
        k = x.shape[1]
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("tp_shard_matmul's backward runs in full f32: set "
                               "torch.backends.cuda.matmul.allow_tf32 = False")
        gy = gy.contiguous()
        width = k if mode == "row" else n_out
        shard = _shard(w_store, offset, width, mode)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            if mode == "col":  # gy (M, N) @ columns.T
                dx = torch.matmul(gy.float(), shard.float().t())
            else:  # gy @ rows.T (row) or gy @ rows (col_t): the same rows read the other way
                dx = _launch(gy.to(x.dtype), w_store, offset, k, "col_t" if mode == "row" else "row",
                             torch.float32 if mode == "row" else x.dtype)
                tp_shard_matmul.backward_launches += int(gy.numel() > 0 and k > 0)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            xf, gf = x.float(), gy.float()
            part = torch.matmul(gf.t(), xf) if mode == "col_t" else torch.matmul(xf.t(), gf)
            dw = torch.zeros_like(w_store)
            _shard(dw, offset, width, mode).copy_(part)
        return dx, dw, None, None, None, None


_build.counted(tp_shard_matmul)
tp_shard_matmul.backward_launches = 0
