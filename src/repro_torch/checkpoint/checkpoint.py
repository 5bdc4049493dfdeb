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
    split again on load; a bf16 tensor is written as f32 and cast back;
  * elastic across processes (``layout``, a train step's ``PoolLayout``):
    each leaf is gathered whole onto rank 0 alone (its ZeRO slices, or the
    blocks of a leaf the rules shard over data, over each data group, then
    its model shards over rank 0's model group), rank 0 writes the leaves
    and publishes the directory, and every rank waits for it at a barrier.
    A load places each whole leaf onto the target as it lies, whatever
    layout and rules wrote it: across processes each rank reads its model
    shard, its data block and its ZeRO slice, in one process the whole
    leaf.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.parallel.collectives import gather_first
from repro_torch.training.optimizer import Zero1Shards


def tree_leaves(tree) -> Iterator:
    """Leaves in the reference's order: dict keys sorted, tuples and lists
    in order; None holds no leaf."""
    return (leaf for _, leaf in _leaves_with_path(tree))


def _leaves_with_path(tree, prefix: tuple = ()) -> Iterator:
    """(path, leaf) in ``tree_leaves``' order; a path holds dict keys and
    tuple or list indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _leaves_with_path(x, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


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


def _whole(path, leaf, layout):
    """The leaf whole on rank 0, None on the other ranks: its ZeRO slices
    (or its data blocks) gathered over each data group to the group's first
    member (data rank 0), then its model shards over the model group of
    those members, rank 0's (collectives: every rank of the pool calls
    this, leaf by leaf in one order)."""
    if isinstance(leaf, Zero1Shards):
        leaf = leaf.full() if leaf.group is None else gather_first(leaf.parts[0], leaf.group, leaf.dim)
    elif layout.data_dim(path) is not None:
        leaf = gather_first(leaf, layout.level.data, layout.data_dim(path))
    dim = layout.model_dim(path)
    if dim is not None and layout.level.data_rank == 0:
        leaf = gather_first(leaf, layout.level.model, dim)
    return leaf if layout.pool.rank == 0 else None


def save_checkpoint(ckpt_dir: str, step: int, tree, metadata: Optional[dict] = None, layout=None) -> str:
    """Write ``tree``'s leaves whole and publish them as ``step_<n>``
    atomically. ``layout``: the train state's ``PoolLayout`` across
    processes; every rank calls this, rank 0 writes."""
    writer = layout is None or layout.pool.rank == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if writer:
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
        os.makedirs(tmp, exist_ok=True)
    leaves = list(_leaves_with_path(tree))
    manifest = {"step": step, "treedef": "repro_torch", "n_leaves": len(leaves), "leaves": [],
                "metadata": metadata or {}}
    for i, (path, leaf) in enumerate(leaves):
        if layout is not None:
            leaf = _whole(path, leaf, layout)
        if not writer:
            continue
        arr = _as_numpy(leaf)
        fn = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"].append({"path": fn, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
    if layout is not None:
        layout.pool.barrier()  # published before any rank goes on
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
    its dtype, a ``Zero1Shards`` split as it is (across processes this
    rank's slice alone), else the numpy array."""
    if isinstance(target, Zero1Shards):
        n = arr.shape[target.dim] // target.n
        mine = range(target.n) if target.group is None else (target.index,)
        return Zero1Shards(target.dim, [_tensor(np.take(arr, range(r * n, (r + 1) * n), target.dim), p)
                                        for r, p in zip(mine, target.parts)], target.index, target.group)
    if isinstance(target, torch.Tensor):
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint leaf of shape {arr.shape}, target {tuple(target.shape)}")
        return _tensor(arr, target)
    return np.array(arr)


def _tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.array(arr)).to(device=like.device, dtype=like.dtype)


def load_checkpoint(path: str, target_tree, layout=None):
    """Restore into the structure of ``target_tree``, each leaf placed as
    the target's leaf is (device, dtype, ZeRO-1 split; with ``layout``, a
    train step's ``PoolLayout``, this rank's model shard and data block).
    Returns (tree, step, metadata)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    targets = list(_leaves_with_path(target_tree))
    if len(targets) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, target has {len(targets)}")
    out = []
    for spec, (p, t) in zip(manifest["leaves"], targets):
        arr = np.load(os.path.join(path, spec["path"]), mmap_mode="r")
        if layout is not None:  # this rank's model shard, and of that its data block
            for dim, n, i in ((layout.model_dim(p), layout.level.tp, layout.level.model_rank),
                              (layout.data_dim(p), layout.level.dp, layout.level.data_rank)):
                if dim is not None:
                    w = arr.shape[dim] // n
                    arr = np.take(arr, range(i * w, (i + 1) * w), dim)
        out.append(_like(arr, t))
    return _unflatten(target_tree, iter(out)), manifest["step"], manifest.get("metadata", {})


def assign_(dst, src) -> None:
    """Copy every leaf of ``src`` into the same leaf of ``dst`` in place (a
    resumed step function keeps its bound views); a ``Zero1Shards`` leaf of
    ``dst`` takes its slices of a whole tensor, or of a ``Zero1Shards`` of
    the same split part by part."""
    with torch.no_grad():
        for d, s in zip(tree_leaves(dst), tree_leaves(src)):
            if isinstance(d, Zero1Shards):
                if isinstance(s, Zero1Shards) and (s.n, s.index, len(s.parts)) == (d.n, d.index, len(d.parts)):
                    pieces = s.parts
                else:
                    whole = s.full() if isinstance(s, Zero1Shards) else s
                    n = whole.shape[d.dim] // d.n
                    pieces = [whole.narrow(d.dim, (d.index + r) * n, n) for r in range(len(d.parts))]
                for part, piece in zip(d.parts, pieces):
                    part.copy_(piece)
            else:
                d.copy_(s)
