"""Weight carry between the two packages.

A parameter tree of the reference (a nested dict of arrays, keys such as
``embed``, ``periods/pos0/mixer/wq``, ``lm_head``) becomes the port's tree
of tensors with the same keys, shapes and layouts, on a given device and
dtype; ``to_numpy`` goes back. Arrays are passed as numpy, so this module
needs nothing of the reference.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.params import tree_map


def _tensor(x, device: torch.device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16 has no torch counterpart in numpy form
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy: jax's buffers are read-only
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def to_torch(tree, device: Optional[Union[str, torch.device]] = None, dtype: Optional[torch.dtype] = None):
    """Nested dict of arrays -> nested dict of tensors (same keys and shapes)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev, dtype), tree)


def to_numpy(tree):
    """Nested dict of tensors -> nested dict of numpy arrays (bf16 as f32)."""
    def conv(t: torch.Tensor):
        t = t.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()

    return tree_map(conv, tree)
