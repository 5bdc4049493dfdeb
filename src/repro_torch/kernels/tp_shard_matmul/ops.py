"""Wrapper of the TP-shard-selecting matmul (csrc/tp_shard_matmul.cu).

CPU tensors take the plain version in ref.py; CUDA tensors launch the
kernel or raise. Modes: "col" and "row" select a column or row shard of a
(K, N) weight; "col_t" selects rows of a weight stored transposed, (N, K),
as the tied LM head reads the embedding's vocab rows.
``tp_shard_matmul.launches`` counts wrapper calls that launched: every call
launches one kernel, split-K reduced in the same launch (bf16 ``wgmma_mm``;
f32 ``skinny_mm`` at M <= 8 and ``fma_mm`` above). A call inside a CUDA
graph capture launches nothing: the graph's owner
(``core.tp_switch.ExecutableCache``) takes it back off the count and adds it
again at every replay.
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
        base = offset
    elif mode == "row":
        if cols != n_out or not 0 <= offset <= rows - k:
            raise ValueError(f"row: x {tuple(x.shape)}, w_store {tuple(w_store.shape)}, offset {offset}, n_out {n_out}")
        base = offset * cols
    elif mode == "col_t":
        if cols != k or not 0 <= offset <= rows - n_out:
            raise ValueError(f"col_t: x {tuple(x.shape)}, w_store {tuple(w_store.shape)}, offset {offset}, n_out {n_out}")
        if out_dtype != torch.float32:
            raise TypeError(f"col_t computes the tied head's logits: out_dtype must be float32, got {out_dtype}")
        base = offset * cols
    else:
        raise ValueError(f"mode must be 'col', 'row' or 'col_t', got {mode!r}")

    if x.device.type == "cpu" and w_store.device.type == "cpu":
        return tp_shard_matmul_ref(x, w_store, offset, mode=mode, n_out=n_out, out_dtype=out_dtype)
    if x.device.type != "cuda" or w_store.device != x.device:
        raise ValueError(f"x and w_store must lie on one CUDA device, got {x.device} and {w_store.device}")
    if not (x.is_contiguous() and w_store.is_contiguous()):
        raise ValueError("x and w_store must be contiguous")

    y = torch.empty((m, n_out), dtype=out_dtype, device=x.device)
    if y.numel() == 0 or k == 0:
        return y.zero_()
    lib = _lib()
    dt = _DTYPES[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ws, cnt = _build.scratch("tp_shard_matmul", x.device, stream)
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
    tp_shard_matmul.launches += 1
    return y


_build.counted(tp_shard_matmul)
