"""Compressed all-reduce of gradient trees over a mesh axis
(``repro/optim/compress.py``).

The reference quantizes a tree to bf16, or to int8 with an f32 scale,
``psum``s it over the ``pod`` axis of a ``shard_map`` and dequantizes. The
port runs the same arithmetic over one axis of a device-list mesh
(:mod:`repro_torch.launch.mesh`): the entries that agree off the axis
reduce together, in the axis's order, on the first of them, and every
entry takes the result. The payload moves compressed (bf16, or int8
widened to int32 on the receiver, where the sum is exact), and each
reduction counts as an all-reduce in
:data:`repro_torch.core.distributed.COLLECTIVES`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distributed import DeviceMesh, note_collective, on_entry
from repro_torch.precision.policy import _flatten, tree_leaves, tree_map

__all__ = ["compress_tree", "decompress_tree", "psum_compressed"]

f32 = torch.float32


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / scale), -127, 127)``, rounding half to even as
    ``jnp.round``."""
    return torch.clamp(torch.round(xf / scale), -127, 127)


def compress_tree(tree, method: str):
    """``"bf16"``: every leaf cast to bf16. ``"int8"``: every leaf becomes
    ``(int8 data, f32 scale)``, the scale ``max|x| / 127`` (1.0 for an
    all-zero leaf)."""
    if method == "bf16":
        return tree_map(lambda x: x.to(torch.bfloat16), tree)
    if method == "int8":
        def q(x):
            xf = x.to(f32)
            scale = _scale_of(torch.max(torch.abs(xf)))
            return _quantize(xf, scale).to(torch.int8), scale
        return tree_map(q, tree)
    raise ValueError(method)


def decompress_tree(tree, method: str, like):
    """The inverse of :func:`compress_tree` into ``like``'s dtypes."""
    if method == "bf16":
        return tree_map(lambda x, ref: x.to(ref.dtype), tree, like)
    if method == "int8":
        flat = tree_leaves(tree)
        refs, rebuild = _flatten(like)
        return rebuild([(q.to(f32) * s).to(ref.dtype)
                        for q, s, ref in zip(flat[0::2], flat[1::2], refs)])
    raise ValueError(method)


def _groups(mesh: DeviceMesh, axis: str) -> list[list[tuple]]:
    """The entries of each line of ``mesh`` along ``axis``, in axis order."""
    i = mesh.axis_names.index(axis)
    lines: dict[tuple, list] = {}
    for e in np.ndindex(*mesh.devices.shape):
        lines.setdefault(e[:i] + e[i + 1:], []).append(tuple(e))
    return list(lines.values())


def psum_compressed(blocks: list, mesh: DeviceMesh, axis: str, method: str | None) -> list:
    """All-reduce ``blocks`` (one tree per mesh entry, row-major, each on
    its entry's device) over ``axis`` to the mean, with optional
    compression; returns one tree per entry. ``None`` sums in the leaves'
    dtype; ``"bf16"`` rounds each value to bf16 and sums in f32; ``"int8"``
    agrees on one scale first (the max of the entries' ``max|x|``), then
    sums the int8 payloads exactly in int32 and returns ``total * scale /
    n``: an unbiased mean."""
    if method not in (None, "bf16", "int8"):
        raise ValueError(method)
    entries = [tuple(e) for e in np.ndindex(*mesh.devices.shape)]
    if len(blocks) != len(entries):
        raise ValueError(f"psum_compressed: {len(blocks)} trees for {len(entries)} entries")
    at = dict(zip(entries, blocks))
    flat = {e: _flatten(t)[0] for e, t in at.items()}
    rebuild = _flatten(blocks[0])[1]
    out = {}
    for line in _groups(mesh, axis):
        n, root = len(line), line[0]
        dev = mesh.devices[root]
        results = []
        for j, x0 in enumerate(flat[root]):
            xs = [flat[e][j] for e in line]
            with on_entry(mesh, root):
                if method is None:
                    total = xs[0]
                    for x in xs[1:]:
                        total = total + x.to(dev)
                    res = total / n
                    moved = x0.numel() * x0.element_size()
                elif method == "bf16":
                    total = xs[0].to(torch.bfloat16).to(f32)
                    for x in xs[1:]:
                        total = total + x.to(torch.bfloat16).to(dev).to(f32)
                    res = (total / n).to(x0.dtype)
                    moved = x0.numel() * 2
                else:
                    amaxes = [torch.max(torch.abs(x.to(f32))) for x in xs]
                    amax = amaxes[0]
                    for a in amaxes[1:]:
                        amax = torch.maximum(amax, a.to(dev))
                    note_collective("all-reduce", {e: (n - 1) * 4 for e in line})  # the scale
                    scale = _scale_of(amax)
                    total = None
                    for x in xs:
                        q = _quantize(x.to(f32), scale.to(x.device)).to(torch.int8)
                        q = q.to(dev).to(torch.int32)
                        total = q if total is None else total + q
                    res = (total.to(f32) * scale / n).to(x0.dtype)
                    moved = x0.numel()
            note_collective("all-reduce", {e: (n - 1) * moved for e in line})
            results.append(res)
        for e in line:
            out[e] = rebuild([r.to(mesh.devices[e]) for r in results])
    return [out[e] for e in entries]
