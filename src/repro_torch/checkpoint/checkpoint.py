"""Fault-tolerant checkpointing: atomic and in the reference's format
(mirrors repro/checkpoint/checkpoint.py).

  * atomic: leaves are written into ``<dir>/.tmp-<step>-<pid>``, then the
    directory is renamed to ``<dir>/step_<n>``: a crash mid-write never
    corrupts the latest checkpoint;
  * the reference's layout: one ``leaf_{i:05d}.npy`` per leaf, whole
    (unsharded), and a ``manifest.json``. Leaves are taken in the order
    ``jax.tree_util`` flattens the same tree in (dict keys sorted, tuples
    and lists in order), so a checkpoint written by either package loads
    into the other. A ZeRO-1 moment (``Zero1Shards``) is written whole and
    split again on load; a bf16 tensor is written as f32 and cast back.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.training.optimizer import Zero1Shards


def tree_leaves(tree) -> Iterator:
    """Leaves in the reference's order: dict keys sorted, tuples and lists
    in order; None holds no leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from tree_leaves(x)
    elif tree is not None:
        yield tree


def _unflatten(tree, leaves: Iterator):
    """A tree of ``tree``'s structure holding the next leaves of ``leaves``."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(x, leaves) for x in tree)
    return None if tree is None else next(leaves)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, Zero1Shards):
        leaf = leaf.full()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: Optional[dict] = None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    leaves = list(tree_leaves(tree))
    manifest = {"step": step, "treedef": "repro_torch", "n_leaves": len(leaves), "leaves": [],
                "metadata": metadata or {}}
    for i, leaf in enumerate(leaves):
        arr = _as_numpy(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"path": fn, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    return final


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)$", name)
        if m:
            steps.append((int(m.group(1)), name))
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


def _like(arr: np.ndarray, target):
    """A loaded leaf placed as ``target`` is: a tensor on its device and in
    its dtype, a ``Zero1Shards`` split as it is, else the numpy array."""
    if isinstance(target, Zero1Shards):
        full = torch.from_numpy(arr)
        sizes = [p.shape[target.dim] for p in target.parts]
        return Zero1Shards(target.dim, [c.to(device=p.device, dtype=p.dtype).contiguous()
                                        for c, p in zip(torch.split(full, sizes, target.dim), target.parts)])
    if isinstance(target, torch.Tensor):
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint leaf of shape {arr.shape}, target {tuple(target.shape)}")
        return torch.from_numpy(arr).to(device=target.device, dtype=target.dtype)
    return arr


def load_checkpoint(path: str, target_tree):
    """Restore into the structure of ``target_tree``, each leaf placed as
    the target's leaf is (device, dtype, ZeRO-1 split). Returns (tree,
    step, metadata)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    targets = list(tree_leaves(target_tree))
    if len(targets) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, target has {len(targets)}")
    out = [_like(np.load(os.path.join(path, spec["path"])), t) for spec, t in zip(manifest["leaves"], targets)]
    return _unflatten(target_tree, iter(out)), manifest["step"], manifest.get("metadata", {})


def assign_(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst`` in place (a
    resumed step function keeps its bound views); a ``Zero1Shards`` leaf of
    ``dst`` takes its slices of a whole tensor."""
    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            if isinstance(d, Zero1Shards):  # from a whole tensor or from shards
                whole = s.full() if isinstance(s, Zero1Shards) else s
                sizes = [p.shape[d.dim] for p in d.parts]
                for part, piece in zip(d.parts, torch.split(whole, sizes, d.dim)):
                    part.copy_(piece)
            else:
                d.copy_(s)
