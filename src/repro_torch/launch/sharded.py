"""Tensors laid out over a device-list mesh, and the collectives over its
named axes: the one-process lowering's counterpart of GSPMD's layouts
(a port-only module beside ``launch/mesh.py``, whose plan it lays out).

PyTorch has no GSPMD in one process, so the port lays a tensor out itself:
a :class:`Sharded` holds one block per mesh entry, on that entry's device,
as its :class:`~repro_torch.launch.mesh.NamedSharding` says, and the
lowering (``models/tasks.py``) moves data only through :func:`all_gather`,
:func:`reduce_scatter` and :func:`all_reduce` over named axes. Each sums in
a fixed order (the parts' order, mesh index order; never a float atomic)
and counts its calls and bytes in
:data:`repro_torch.core.distributed.COLLECTIVES`: per kind, the bytes that
the entry taking in the most has received from other entries (a device's
share).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.distributed import DeviceMesh, note_collective, on_entry
from repro_torch.launch.mesh import NamedSharding, P, data_axes, part_axes
from repro_torch.precision.policy import _flatten

__all__ = ["Sharded", "shard", "gather", "shard_tree", "gather_tree", "held_bytes", "entries",
           "blocks_of", "block_slices", "all_gather", "reduce_scatter", "all_reduce"]


def entries(mesh: DeviceMesh) -> list[tuple]:
    """The mesh's indices in row-major order."""
    return [tuple(i) for i in np.ndindex(*mesh.devices.shape)]


def block_slices(shape: tuple, spec: P, mesh: DeviceMesh, index: tuple) -> tuple:
    """The slices of a ``shape`` tensor that entry ``index`` holds under
    ``spec`` (a dim sharded over several axes splits in their row-major
    order, as JAX's)."""
    sizes, pos = mesh.shape, {a: i for i, a in enumerate(mesh.axis_names)}
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, part in zip(shape, parts):
        axes = part_axes(part)
        n = math.prod(sizes[a] for a in axes)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {axes} ({n}); fit the spec")
        i = 0
        for a in axes:
            i = i * sizes[a] + index[pos[a]]
        size = dim // n
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


class Sharded:
    """A tensor of ``shape`` and ``dtype`` laid out per ``sharding``:
    ``blocks`` (a numpy object array of the mesh's shape) holds each
    entry's block, on that entry's device. Entries whose spec coordinates
    agree hold equal copies (a replicated dim)."""

    __slots__ = ("sharding", "shape", "dtype", "blocks")

    def __init__(self, sharding: NamedSharding, shape: tuple, dtype: torch.dtype,
                 blocks: np.ndarray):
        self.sharding, self.shape, self.dtype, self.blocks = (sharding, tuple(shape), dtype,
                                                              blocks)

    @property
    def mesh(self) -> DeviceMesh:
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    def slices(self, index: tuple) -> tuple:
        return block_slices(self.shape, self.spec, self.mesh, index)

    def distinct(self) -> list[tuple]:
        """The entries that hold the distinct blocks: those at 0 on every
        axis the spec does not use, in mesh order."""
        used = {a for part in self.spec for a in part_axes(part)}
        keep = [i for i, a in enumerate(self.mesh.axis_names) if a not in used]
        return [e for e in entries(self.mesh) if all(e[i] == 0 for i in keep)]

    def __repr__(self) -> str:
        return (f"Sharded({list(self.shape)}, {self.dtype}, {self.spec!r} over "
                f"{self.mesh.shape})")


def blocks_of(mesh: DeviceMesh, make) -> np.ndarray:
    """``make(entry)`` for every entry, as a numpy object array of the
    mesh's shape."""
    out = np.empty(mesh.devices.shape, dtype=object)
    for e in entries(mesh):
        out[e] = make(e)
    return out


def shard(x: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``x`` laid out per ``sharding``: each entry's block copied onto its
    device (the counterpart of ``jax.device_put``; no collective)."""
    mesh = sharding.mesh

    def block(e):
        with on_entry(mesh, e):
            return x[block_slices(x.shape, sharding.spec, mesh, e)].to(
                mesh.devices[e], copy=True).contiguous()

    return Sharded(sharding, tuple(x.shape), x.dtype, blocks_of(mesh, block))


def gather(x: Sharded, device=None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: the first entry's), from
    the distinct blocks (a read of the layout, counted as no collective)."""
    device = x.mesh.devices.flat[0] if device is None else torch.device(device)
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    for e in x.distinct():
        out[x.slices(e)] = x.blocks[e].to(device)
    return out


def shard_tree(tree, shardings):
    """``tree`` (tensors, or :class:`Sharded` laid out otherwise) laid out
    per ``shardings`` (a tree of :class:`NamedSharding` of its structure); a
    leaf already laid out so passes as it is."""
    leaves, rebuild = _flatten(tree)
    targets = _flatten(shardings)[0]
    out = []
    for x, s in zip(leaves, targets):
        if isinstance(x, Sharded):
            same = x.mesh is s.mesh and x.spec == s.spec
            out.append(x if same else shard(gather(x), s))
        else:
            out.append(shard(x, s))
    return rebuild(out)


def gather_tree(tree, device=None):
    """Every :class:`Sharded` leaf of ``tree`` gathered (:func:`gather`)."""
    leaves, rebuild = _flatten(tree)
    return rebuild([gather(x, device) if isinstance(x, Sharded) else x for x in leaves])


def held_bytes(tree) -> dict[tuple, int]:
    """Bytes each mesh entry holds of the :class:`Sharded` leaves of
    ``tree`` (their blocks, as laid out)."""
    out: dict[tuple, int] = {}
    for x in _flatten(tree)[0]:
        if isinstance(x, Sharded):
            for e in entries(x.mesh):
                b = x.blocks[e]
                out[e] = out.get(e, 0) + b.numel() * b.element_size()
    return out


# -- collectives over named axes --------------------------------------------------------


def _agree(e: tuple, f: tuple, fixed: list[int]) -> bool:
    return all(e[i] == f[i] for i in fixed)


def all_gather(x: Sharded, dst: tuple, axes) -> tuple[torch.Tensor, tuple]:
    """The blocks of every entry that agrees with ``dst`` off ``axes``,
    assembled on ``dst``'s device: ``(tensor, region)``, the region the
    slices of the whole tensor that it covers (the whole tensor when
    ``axes`` are all of the spec's axes). A block ``dst`` holds is its own;
    each other distinct block comes from the first entry in mesh order that
    holds it. Counts one all-gather of the bytes taken from other
    entries."""
    mesh = x.mesh
    fixed = [i for i in range(len(mesh.axis_names)) if mesh.axis_names[i] not in axes]
    group = [e for e in entries(mesh) if _agree(e, dst, fixed)]
    pieces: dict[tuple, tuple] = {}
    for e in group:
        sl = tuple((s.start, s.stop) for s in x.slices(e))
        if sl not in pieces or e == dst:
            pieces[sl] = e
    lo = [min(sl[d][0] for sl in pieces) for d in range(len(x.shape))]
    hi = [max(sl[d][1] for sl in pieces) for d in range(len(x.shape))]
    region = tuple(slice(a, b) for a, b in zip(lo, hi))
    moved = 0
    with on_entry(mesh, dst):
        dev = mesh.devices[dst]
        out = torch.empty([b - a for a, b in zip(lo, hi)], dtype=x.dtype, device=dev)
        for sl, e in pieces.items():
            block = x.blocks[e]
            out[tuple(slice(a - o, b - o) for (a, b), o in zip(sl, lo))] = block
            if e != dst:
                moved += block.numel() * block.element_size()
    note_collective("all-gather", {dst: moved})
    return out, region


def _inside(block: tuple, region: tuple) -> bool:
    return all(r.start <= b.start and b.stop <= r.stop for b, r in zip(block, region))


def reduce_scatter(parts: list, sharding: NamedSharding, shape: tuple, axes) -> Sharded:
    """Each entry's block of the sum of ``parts`` over ``axes``: ``parts``
    is ``[(src, region, tensor)]``, ``tensor`` the part of the whole that
    ``src`` contributes over ``region`` (a data index's compute entry
    stands for its whole group). An entry sums, in ``parts``' order, the
    parts whose source agrees with it on every batch axis not in ``axes``
    and whose region holds its block: over the data axes every data
    index's gradient (a reduce-scatter), over ``model`` only its own data
    index's rows (a scatter within the group). Counts one reduce-scatter
    of what each entry takes from the others."""
    mesh = sharding.mesh
    fixed = [i for i, a in enumerate(mesh.axis_names)
             if a in data_axes(mesh) and a not in axes]
    received, dtype = {}, parts[0][2].dtype

    def block(e):
        want = block_slices(shape, sharding.spec, mesh, e)
        acc, got = None, 0
        with on_entry(mesh, e):
            dev = mesh.devices[e]
            for src, region, t in parts:
                if not (_agree(src, e, fixed) and _inside(want, region)):
                    continue
                piece = t[tuple(slice(w.start - r.start, w.stop - r.start)
                                for w, r in zip(want, region))].to(dev)
                if src != e:
                    got += piece.numel() * piece.element_size()
                acc = piece.clone() if acc is None else acc + piece
        if acc is None:
            raise ValueError(f"reduce_scatter: no part covers entry {e}'s block")
        received[e] = got
        return acc.contiguous()

    blocks = blocks_of(mesh, block)
    note_collective("reduce-scatter", received)
    return Sharded(sharding, shape, dtype, blocks)


def all_reduce(values: list, op: str = "sum") -> torch.Tensor:
    """``values`` (``[(entry, tensor)]``, one per participating entry)
    combined in their order, ``"sum"`` or ``"all"`` (logical and), on the
    first entry's device; every entry takes it in (counted: the others'
    values' bytes). Differentiable for ``"sum"``."""
    dev = values[0][1].device
    acc = values[0][1]
    for _, t in values[1:]:
        t = t.to(dev)
        acc = acc + t if op == "sum" else acc & t
    t0 = values[0][1]
    each = (len(values) - 1) * t0.numel() * t0.element_size()
    note_collective("all-reduce", {e: each for e, _ in values})
    return acc
