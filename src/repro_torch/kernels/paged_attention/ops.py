"""Wrapper of paged flash-decode (csrc/paged_attention.cu).

CPU and meta tensors take the plain version in ref.py; CUDA tensors launch
the kernel or raise. ``paged_decode_attention.launches`` counts kernel launches:
one per call, the splits of a sequence merged in the same launch. A call
inside a CUDA graph capture launches nothing: the graph's owner
(``core.tp_switch.ExecutableCache``) takes it back off the count and adds it
again at every replay.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import T_SPLIT, paged_decode_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
MAX_GROUP = 64  # query rows per KV head that fit the kernel's shared memory


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.paged_decode_t_split.restype = i
        if lib.paged_decode_t_split() != T_SPLIT:
            raise RuntimeError(f"paged_attention.cu splits at {lib.paged_decode_t_split()} tokens, ref.py at {T_SPLIT}")
        lib.paged_decode_scratch.argtypes = [i, i, i, i, i, i, ctypes.POINTER(ll), ctypes.POINTER(ll)]
        lib.paged_decode_scratch.restype = None
        fn.argtypes = [p, p, p, p, p, p, p, ll, p, ll, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = i
    return lib


_SCRATCH_TOO_SMALL = -1


def _grow_scratch(lib, device: torch.device, stream: int, dims: Tuple[int, ...]):
    """The splits' f32 workspace and per-(sequence, KV head) counters, grown to this call's need."""
    need_ws, need_cnt = ctypes.c_longlong(), ctypes.c_longlong()
    lib.paged_decode_scratch(*dims, ctypes.byref(need_ws), ctypes.byref(need_cnt))
    return _build.scratch("paged_attention", device, stream, (need_ws.value, torch.float32, need_cnt.value))


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    *,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over paged KV.

    q: (B, KV, G, hd); k/v_pages: (num_pages, page_size, KV, hd);
    block_tables: (B, n_pages) int32; seq_lens: (B,) int32, each >= 1 (a
    sequence always holds at least the token being decoded).
    """
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"q {tuple(q.shape)}, k_pages {tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)}")
    B, KV, G, hd = q.shape
    if k_pages.shape[2:] != (KV, hd):
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError(f"q and pages must share a dtype in {list(_DTYPES)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"tables {tuple(block_tables.shape)} / lens {tuple(seq_lens.shape)} for batch {B}")

    if q.device.type in _build.PLAIN_DEVICES:
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables, seq_lens, softcap=softcap)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k_pages, v_pages, block_tables, seq_lens)):
        raise ValueError("q, pages, block_tables and seq_lens must lie on one CUDA device")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    if hd not in HEAD_DIMS or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"head_dim {hd} must be one of {HEAD_DIMS} and 1 <= G={G} <= {MAX_GROUP}")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages, block_tables, seq_lens)):
        raise ValueError("all inputs must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k_pages and v_pages must start on a 16-byte boundary (the kernel reads 16-byte vectors)")

    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    dims = (B, KV, G, hd, k_pages.shape[1], block_tables.shape[1])
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            seq_lens.data_ptr(), out.data_ptr())
    tail = (*dims, _DTYPES[q.dtype], float(softcap or 0.0), stream)
    ws, cnt = _build.scratch("paged_attention", dev, stream)
    rc = _SCRATCH_TOO_SMALL
    if ws is not None:
        rc = lib.paged_decode_attention(*args, ws.data_ptr(), ws.numel(), cnt.data_ptr(), cnt.numel(), *tail)
    if rc == _SCRATCH_TOO_SMALL:
        ws, cnt = _grow_scratch(lib, dev, stream, dims)
        rc = lib.paged_decode_attention(*args, ws.data_ptr(), ws.numel(), cnt.data_ptr(), cnt.numel(), *tail)
    _build.check(lib, rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


_build.counted(paged_decode_attention)
