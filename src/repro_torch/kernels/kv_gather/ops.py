"""Wrappers of paged-KV gather and scatter (csrc/kv_gather.cu).

CPU and meta tensors take the plain versions in ref.py; CUDA tensors launch
the kernel or raise. ``kv_gather.launches`` and ``kv_scatter.launches`` count
kernel launches. Page ids come from the host (a numpy array, a list or a CPU
integer tensor), as the reference's ``ops.py`` takes numpy: they are checked
there and then copied to the card as int32.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_gather.ref import kv_gather_ref, kv_scatter_ref


def _lib() -> ctypes.CDLL:
    lib = _build.load("kv_gather")
    for fn in (lib.kv_gather, lib.kv_scatter):
        if fn.argtypes is None:
            p, i64 = ctypes.c_void_p, ctypes.c_longlong
            fn.argtypes = [p, p, p, i64, i64, p]
            fn.restype = ctypes.c_int
    return lib


def _host_ids(page_ids, num_pages: int, distinct: bool) -> np.ndarray:
    """page_ids as a 1-D int32 numpy array, each in [0, num_pages)."""
    if isinstance(page_ids, torch.Tensor):
        if page_ids.device.type != "cpu":
            raise ValueError("page_ids must lie on the host (numpy or a CPU tensor)")
        page_ids = page_ids.numpy()
    ids = np.asarray(page_ids)
    if ids.size == 0:
        return np.zeros(0, np.int32)
    if ids.ndim != 1 or not np.issubdtype(ids.dtype, np.integer):
        raise ValueError(f"page_ids must be a 1-D integer array, got {ids.dtype} {ids.shape}")
    if ids.min() < 0 or ids.max() >= num_pages:
        raise IndexError(f"page_ids outside [0, {num_pages}): min {ids.min()}, max {ids.max()}")
    if distinct:
        seen = np.zeros(num_pages, np.bool_)
        seen[ids] = True
        if int(seen.sum()) != ids.size:
            raise ValueError("kv_scatter needs distinct page_ids: parallel writes to one page would race")
    return ids.astype(np.int32, copy=False)


def _device_ids(ids: np.ndarray, dev: torch.device) -> torch.Tensor:
    """ids on the card, copied from pinned memory without a stream sync."""
    return torch.from_numpy(ids).pin_memory().to(dev, non_blocking=True)


def _check_pool(pool: torch.Tensor) -> None:
    if pool.dim() != 2:
        raise ValueError(f"pool must be (num_pages, F), got {tuple(pool.shape)}")
    if not pool.is_contiguous():
        raise ValueError("pool must be contiguous")


def kv_gather(pool: torch.Tensor, page_ids) -> torch.Tensor:
    """Aggregate fragmented pages into a contiguous staging buffer.

    pool: (num_pages, F), any dtype; page_ids: (n,) host ints.
    Returns staged (n, F) with staged[i] = pool[page_ids[i]], bit for bit.
    """
    _check_pool(pool)
    ids = _host_ids(page_ids, pool.shape[0], distinct=False)
    if pool.device.type in _build.PLAIN_DEVICES:
        return kv_gather_ref(pool, ids)
    if pool.device.type != "cuda":
        raise ValueError(f"pool on {pool.device}: expected a CPU or CUDA tensor")
    if ids.size == 0 or pool.shape[1] == 0:
        return torch.empty((ids.size, pool.shape[1]), dtype=pool.dtype, device=pool.device)
    return _gather(pool, _device_ids(ids, pool.device))


def _gather(pool: torch.Tensor, dev_ids: torch.Tensor) -> torch.Tensor:
    """The launch behind ``kv_gather``: pool a contiguous (num_pages, F) CUDA
    tensor, dev_ids (n,) int32 page ids on its card, each in range (the
    caller checked them on the host). Also timed on its own, with ids that
    are already on the card."""
    if dev_ids.dtype != torch.int32 or dev_ids.device != pool.device or dev_ids.dim() != 1:
        raise ValueError(f"dev_ids must be 1-D int32 on {pool.device}, got {dev_ids.dtype} on {dev_ids.device}")
    staged = torch.empty((dev_ids.numel(), pool.shape[1]), dtype=pool.dtype, device=pool.device)
    lib = _lib()
    with torch.cuda.device(pool.device):  # the launch goes to the pool's card, whichever is current
        rc = lib.kv_gather(pool.data_ptr(), staged.data_ptr(), dev_ids.data_ptr(), dev_ids.numel(),
                           pool.shape[1] * pool.element_size(), torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(lib, rc, "kv_gather")
    kv_gather.launches += 1
    return staged


def kv_scatter(pool: torch.Tensor, staged: torch.Tensor, page_ids) -> torch.Tensor:
    """Write a contiguous staging buffer into pool pages, in place.

    pool: (num_pages, F); staged: (n, F) of pool's dtype; page_ids: (n,)
    distinct host ints. Sets pool[page_ids[i]] = staged[i] and returns
    ``pool`` itself (same tensor, same data_ptr); other pages keep their
    contents.
    """
    _check_pool(pool)
    ids = _host_ids(page_ids, pool.shape[0], distinct=True)
    if tuple(staged.shape) != (ids.size, pool.shape[1]):
        raise ValueError(f"staged {tuple(staged.shape)} for {ids.size} pages of width {pool.shape[1]}")
    if staged.dtype != pool.dtype:
        raise TypeError(f"staged {staged.dtype} != pool {pool.dtype}")
    if staged.device != pool.device:
        raise ValueError(f"staged on {staged.device}, pool on {pool.device}")
    if not staged.is_contiguous():
        raise ValueError("staged must be contiguous")
    if pool.device.type in _build.PLAIN_DEVICES:
        return kv_scatter_ref(pool, staged, ids)
    if pool.device.type != "cuda":
        raise ValueError(f"pool on {pool.device}: expected a CPU or CUDA tensor")
    if staged.numel() == 0:
        return pool
    dev_ids = _device_ids(ids, pool.device)
    lib = _lib()
    with torch.cuda.device(pool.device):
        rc = lib.kv_scatter(pool.data_ptr(), staged.data_ptr(), dev_ids.data_ptr(), ids.size,
                            pool.shape[1] * pool.element_size(), torch.cuda.current_stream(pool.device).cuda_stream)
    _build.check(lib, rc, "kv_scatter")
    kv_scatter.launches += 1
    return pool


_build.counted(kv_gather)
_build.counted(kv_scatter)
