"""Checkpoint, restore and resume, in the reference's file format.

A state (a tree of dicts, NamedTuples and tuples over tensors, numpy
arrays and Python numbers) is flattened to named leaves and written
atomically (a temporary file, then a rename) as ``step_<step>.npz``. The
leaf names are the reference's: jax's tree-path strings joined by ``||``,
a dict entry as ``['name']``, a NamedTuple field as ``.name`` and a tuple
item as ``[i]``, dict entries in sorted key order; ``None`` and ``()``
hold no leaf. So a file either package writes, the other reads. Torch
tensors are written as numpy arrays of their dtype; the caller converts
what the reference keeps in another type (``serve.lifecycle`` writes a
tick as int32 and a key as its ``uint32`` words). Re-sharding
(``reshard``), which takes the LM mesh's shardings, is ROADMAP A12's.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "save_every", "step_path"]

_SEP = "||"
_STEP = re.compile(r"step_(\d+)\.npz$")


def _paths(tree, prefix=()):
    """``(path, leaf)`` for every leaf of ``tree``, in the reference's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (f"[{k!r}]",))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _paths(getattr(tree, name), prefix + (f".{name}",))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _paths(x, prefix + (f"[{i}]",))
    else:
        yield _SEP.join(prefix), tree


def step_path(ckpt_dir: str, step: int) -> str:
    """The file of step ``step`` in ``ckpt_dir``, named as the reference names it."""
    return os.path.join(ckpt_dir, f"step_{step:010d}.npz")


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, state) -> str:
    """Atomic checkpoint write; returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = step_path(ckpt_dir, step)
    tmp = path + ".tmp"
    flat = {key: _as_numpy(leaf) for key, leaf in _paths(state)}
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)  # atomic on POSIX: no torn checkpoints
    return path


def _rebuild(tree, data, prefix=()):
    """``tree``'s structure with every leaf read from ``data`` under its
    path, in the type of ``tree``'s leaf: a tensor of its dtype on its
    device, a numpy array of its dtype, or a Python int or float. A missing
    leaf raises ``KeyError``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], data, prefix + (f"[{k!r}]",)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, n), data, prefix + (f".{n}",))
                            for n in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(x, data, prefix + (f"[{i}]",)) for i, x in enumerate(tree))
    arr = data[_SEP.join(prefix)]
    if isinstance(tree, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=tree.device,
                                                              dtype=tree.dtype)
    if isinstance(tree, (np.ndarray, np.generic)):
        return np.asarray(arr).astype(tree.dtype)
    return type(tree)(arr)


def restore(ckpt_dir: str, step: int, like):
    """Restore into the structure of ``like`` (a tree of tensors, numpy
    arrays and Python numbers, :func:`_rebuild`)."""
    with np.load(step_path(ckpt_dir, step), allow_pickle=False) as data:
        return _rebuild(like, data)


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir) if (m := _STEP.match(f)))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def save_every(ckpt_dir: str, step: int, state, *, interval: int,
               keep_last: int = 3) -> str | None:
    """Periodic checkpointing with retention: saves at multiples of
    ``interval`` and keeps the newest ``keep_last`` files."""
    if step % interval:
        return None
    path = save(ckpt_dir, step, state)
    for s in _steps(ckpt_dir)[:-keep_last]:
        os.remove(step_path(ckpt_dir, s))
    return path
