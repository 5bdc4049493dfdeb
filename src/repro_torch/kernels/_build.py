"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/lib<name>-<hash>.so`` at the repository root, the hash
covering the source and the flags, so an edited source is rebuilt and a
stale library is never loaded. Nothing is built or loaded at import time:
the first call of a kernel's wrapper builds it, and ``build_all`` builds
every kernel at once, one nvcc process per source, in parallel. ``scratch``
keeps the per-stream workspaces of kernels that reduce across blocks, and
refuses to allocate one inside a CUDA graph capture. ``COUNTED`` lists every
wrapper that counts its launches (``counted``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("tp_shard_matmul", "paged_attention", "kv_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}

# every kernel wrapper with a ``launches`` count, registered by its module
COUNTED: List[Callable] = []

# devices whose tensors take a kernel's plain version: the CPU, and "meta"
# (shapes without data: the dry run counts a program's work on it)
PLAIN_DEVICES = ("cpu", "meta")


def counted(wrapper: Callable) -> Callable:
    """Give ``wrapper`` a launch count at 0 and register it in ``COUNTED``."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names: Sequence[str] = KERNELS, ptxas_verbose: bool = False) -> Dict[str, dict]:
    """Compile every missing library, one nvcc per source, all at once.

    Returns {name: {"seconds": wall time of its nvcc (0.0 if it was already
    built), "log": nvcc's stderr}}. Raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out = {}
    for name in names:
        target = lib_path(name)
        if target.exists() and not ptxas_verbose:
            out[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if ptxas_verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
                       time.perf_counter(), tmp, target)
    failed = []
    for name, (proc, t0, tmp, target) in procs.items():
        _, err = proc.communicate()
        out[name] = {"seconds": time.perf_counter() - t0, "log": err}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{err}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        target = lib_path(name)
        if not target.exists():
            build_all([name])
        lib = ctypes.CDLL(str(target))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} ({lib.error_string(rc).decode()})")


# (kernel, device index, stream) -> (workspace, int32 arrival counters)
_SCRATCH: Dict[Tuple[str, int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def scratch(kernel: str, device: torch.device, stream: int, grow_to: Optional[Tuple[int, torch.dtype, int]] = None):
    """The workspace and arrival counters of a kernel that reduces across
    blocks in one launch, for calls on one stream: (None, None) before the
    first call, else grown to ``grow_to`` = (workspace elements, workspace
    dtype, counters) when given. Reuse is safe: calls on one stream run in
    order, so a call's workspace is not touched again until the call before
    it has ended, and the block that finishes a reduction resets its counter
    to 0 on the way out (so a CUDA graph's every replay finds them at 0). A
    buffer given up by growing goes back to PyTorch's allocator, which hands
    it out again only to work queued after it on the same stream; a graph
    captured before keeps its own reference (``scratch_buffers``).

    A graph replays the pointers it was captured with, so scratch is never
    allocated inside a capture: growing it while the stream captures
    raises. Run the call once on the capturing stream first."""
    key = (kernel, device.index, stream)
    ws, cnt = _SCRATCH.get(key, (None, None))
    if grow_to is not None:
        n_ws, dtype, n_cnt = grow_to
        grow_ws, grow_cnt = ws is None or ws.numel() < n_ws, cnt is None or cnt.numel() < n_cnt
        if (grow_ws or grow_cnt) and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{kernel}: its scratch must be grown before a CUDA graph capture (run the call "
                               f"once on the capturing stream first)")
        if grow_ws:
            ws = torch.empty(max(n_ws, 1), dtype=dtype, device=device)
        if grow_cnt:
            cnt = torch.zeros(max(n_cnt, 1), dtype=torch.int32, device=device)
        _SCRATCH[key] = (ws, cnt)
    return ws, cnt


def scratch_buffers(device: torch.device, stream: int) -> List[torch.Tensor]:
    """Every workspace and counter tensor that calls on ``stream`` use now:
    what a CUDA graph captured on that stream points at, for its owner to
    keep alive as long as the graph."""
    return [t for (_, d, s), pair in _SCRATCH.items() if (d, s) == (device.index, stream) for t in pair]
