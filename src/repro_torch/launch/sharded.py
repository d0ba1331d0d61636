"""Tensors laid out over a device-list mesh, and the collectives over its
named axes: the one-process lowering's counterpart of GSPMD's layouts
(a port-only module beside ``launch/mesh.py``, whose plan it lays out).

PyTorch has no GSPMD in one process, so the port lays a tensor out itself:
a :class:`Sharded` holds one block per mesh entry, on that entry's device,
as its :class:`~repro_torch.launch.mesh.NamedSharding` says, and the
lowering (``models/tasks.py``) moves data only through :func:`all_gather`,
:func:`region_gather`, its inverse :func:`region_write` (a decode step's
new cache entries into the blocks that hold them), :func:`reduce_scatter`
and :func:`all_reduce` over named axes, and, inside a ``model`` group (a
data index's entries in rank order, :class:`Group`), through the differentiable :func:`group_sum`,
:func:`group_copy`, :func:`group_psum`, :func:`seq_gather`,
:func:`seq_scatter` and :func:`all_to_all` (Megatron's g and f, an
all-reduce whose backward is one too, sequence parallelism's all-gather /
reduce-scatter pair, and the MoE combine's exchange).
Each sums in a fixed order (the parts' order, mesh index order, rank
order; never a float atomic) and counts its calls and bytes in
:data:`repro_torch.core.distributed.COLLECTIVES`, a group collective in
its forward and in its backward: per kind, the bytes that the entry
taking in the most has received from other entries (a device's share).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from typing import NamedTuple

from repro_torch.core.distributed import DeviceMesh, note_collective, on_entry
from repro_torch.launch.mesh import NamedSharding, P, data_axes, part_axes
from repro_torch.precision.policy import _flatten

__all__ = ["Sharded", "shard", "gather", "shard_tree", "gather_tree", "held_bytes", "entries",
           "blocks_of", "block_slices", "all_gather", "reduce_scatter", "all_reduce", "pieces",
           "region_gather", "region_write", "Group", "group_sum", "group_copy", "group_psum",
           "seq_gather", "seq_scatter", "all_to_all"]


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


def _overlap(block: tuple, region: tuple) -> tuple | None:
    """The slices of the whole tensor in both ``block`` and ``region``, or
    None where they do not meet."""
    out = tuple(slice(max(b.start, r.start), min(b.stop, r.stop)) for b, r in zip(block, region))
    return None if any(s.start >= s.stop for s in out) else out


def _within(sl: tuple, origin: tuple) -> tuple:
    return tuple(slice(s.start - o.start, s.stop - o.start) for s, o in zip(sl, origin))


def reduce_scatter(parts: list, sharding: NamedSharding, shape: tuple, axes) -> Sharded:
    """Each entry's block of the sum of ``parts`` over ``axes``: ``parts``
    is ``[(src, region, tensor)]``, ``tensor`` the part of the whole that
    ``src`` contributes over ``region`` (a data index's compute entry
    stands for its whole group; under model-axis compute each rank's
    gradient over its ranges). An entry sums, in ``parts``' order, the
    parts whose source agrees with it on every batch axis not in ``axes``
    and whose region meets its block (a part that holds the whole block
    starts or joins the sum as it is, one that holds some of it adds into
    those elements): over the data axes every data index's gradient (a
    reduce-scatter), over ``model`` only its own data index's rows (a
    scatter within the group). Counts one reduce-scatter of what each
    entry takes from the others."""
    mesh = sharding.mesh
    fixed = [i for i, a in enumerate(mesh.axis_names)
             if a in data_axes(mesh) and a not in axes]
    received, dtype = {}, parts[0][2].dtype
    sums: dict = {}  # entries holding the same block of the same parts take one sum

    def block(e):
        want = block_slices(shape, sharding.spec, mesh, e)
        key = (tuple((w.start, w.stop) for w in want), tuple(e[i] for i in fixed))
        acc, got = None, 0
        with on_entry(mesh, e):
            dev = mesh.devices[e]
            done = sums.get(key)
            for src, region, t in parts:
                if not _agree(src, e, fixed):
                    continue
                meet = want if _inside(want, region) else _overlap(want, region)
                if meet is None:
                    continue
                if src != e:
                    got += math.prod(m.stop - m.start for m in meet) * t.element_size()
                if done is not None:
                    continue
                piece = t[_within(meet, region)].to(dev)
                if meet is want:
                    acc = piece.clone() if acc is None else acc + piece
                else:
                    if acc is None:
                        acc = torch.zeros([w.stop - w.start for w in want], dtype=t.dtype,
                                          device=dev)
                    sub = _within(meet, want)
                    acc[sub] = acc[sub] + piece
            if done is not None:
                acc = done.to(dev, copy=True)
            elif acc is not None:
                sums[key] = acc = acc.contiguous()
        if acc is None:
            raise ValueError(f"reduce_scatter: no part covers entry {e}'s block")
        received[e] = got
        return acc

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


# -- regions and model groups (model-axis compute) ----------------------------------------


def pieces(x: Sharded) -> dict:
    """The distinct blocks of ``x``: their slices (as ``(start, stop)``
    pairs) -> the entries holding each, in mesh order."""
    out: dict[tuple, list] = {}
    for e in entries(x.mesh):
        out.setdefault(tuple((s.start, s.stop) for s in x.slices(e)), []).append(e)
    return out


def region_gather(x: Sharded, dst: tuple, region: tuple, held: dict | None = None
                  ) -> torch.Tensor:
    """The slices ``region`` of the whole tensor assembled on ``dst``'s
    device from the distinct blocks that meet it (``held``: :func:`pieces`
    of ``x``): ``dst``'s own where it holds one, else the first entry in
    mesh order that does; the region need not align with the blocks.
    Counts one all-gather of the bytes taken from other entries."""
    held = pieces(x) if held is None else held
    mesh = x.mesh
    moved = 0
    with on_entry(mesh, dst):
        out = torch.empty([r.stop - r.start for r in region], dtype=x.dtype,
                          device=mesh.devices[dst])
        for sl, holders in held.items():
            block = tuple(slice(a, b) for a, b in sl)
            meet = _overlap(block, region)
            if meet is None:
                continue
            src = dst if dst in holders else holders[0]
            piece = x.blocks[src][_within(meet, block)]
            out[_within(meet, region)] = piece
            if src != dst:
                moved += piece.numel() * piece.element_size()
    note_collective("all-gather", {dst: moved})
    return out


def region_write(x: Sharded, src: tuple, region: tuple, t: torch.Tensor,
                 held: dict | None = None) -> None:
    """The inverse of :func:`region_gather`: ``t`` (the values of the slices
    ``region`` of the whole tensor, on ``src``'s device) written in place
    into every block of ``x`` that meets the region, each replica of a
    block too (``held``: :func:`pieces` of ``x``); the region need not align
    with the blocks. Counts one ``"region-write"`` of the bytes that
    entries other than ``src`` take in."""
    held = pieces(x) if held is None else held
    mesh = x.mesh
    received: dict[tuple, int] = {}
    for sl, holders in held.items():
        block = tuple(slice(a, b) for a, b in sl)
        meet = _overlap(block, region)
        if meet is None:
            continue
        piece = t[_within(meet, region)]
        for e in holders:
            with on_entry(mesh, e):
                x.blocks[e][_within(meet, block)] = piece.to(mesh.devices[e])
            if e != src:
                received[e] = received.get(e, 0) + piece.numel() * piece.element_size()
    note_collective("region-write", received)


class Group(NamedTuple):
    """A data index's ``model`` group: its mesh and its entries in rank
    order."""

    mesh: DeviceMesh
    ents: tuple

    def device(self, r: int) -> torch.device:
        return self.mesh.devices[self.ents[r]]

    def on(self, r: int):
        """Rank ``r``'s entry (:func:`~repro_torch.core.distributed.on_entry`)."""
        return on_entry(self.mesh, self.ents[r])


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _rank_sum(ts: list) -> torch.Tensor:
    """``ts`` (not None) added in their order, on the first one's device."""
    acc = ts[0]
    for t in ts[1:]:
        acc = acc + t.to(acc.device)
    return acc


class _GroupSum(torch.autograd.Function):
    """Megatron's g: every rank takes the sum of the present parts in rank
    order; the backward hands each part its rank's cotangent, the whole one
    (the ranks' copies downstream compute alike)."""

    @staticmethod
    def forward(ctx, grp, present, *parts):
        ctx.grp, ctx.present = grp, present
        acc = _rank_sum(list(parts))
        outs = []
        for j in range(len(grp.ents)):
            with grp.on(j):
                outs.append(acc.to(grp.device(j), copy=True))
        each = {e: sum(_nbytes(t) for r, t in zip(present, parts) if r != j)
                for j, e in enumerate(grp.ents)}
        note_collective("all-reduce", each)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        grads = []
        for r in ctx.present:
            d = douts[r]
            grads.append(None if d is None else d.to(ctx.grp.device(r)))
        return (None, None, *grads)


class _GroupCopy(torch.autograd.Function):
    """Megatron's f: each rank's tensor passes as it is; the backward hands
    every rank the sum of the ranks' cotangents in rank order (an
    all-reduce)."""

    @staticmethod
    def forward(ctx, grp, *xs):
        ctx.grp = grp
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *douts):
        grp = ctx.grp
        got = [(j, d) for j, d in enumerate(douts) if d is not None]
        if not got:
            return (None,) * (1 + len(douts))
        acc = _rank_sum([d for _, d in got])
        out = []
        for r in range(len(douts)):
            with grp.on(r):
                out.append(acc.to(grp.device(r), copy=True))
        note_collective("all-reduce", {e: sum(_nbytes(d) for j, d in got if j != r)
                                       for r, e in enumerate(grp.ents)})
        return (None, *out)


class _SeqGather(torch.autograd.Function):
    """Sequence parallelism's all-gather: every rank takes the ranks'
    ranges concatenated along ``dim``; the backward reduce-scatters the
    cotangents (rank ``r`` takes the sum over the ranks, in rank order, of
    their cotangents' range ``r``)."""

    @staticmethod
    def forward(ctx, grp, ranges, dim, *xs):
        ctx.grp, ctx.ranges, ctx.dim = grp, ranges, dim
        outs = []
        for j in range(len(xs)):
            with grp.on(j):
                dev = grp.device(j)
                outs.append(torch.cat([x.to(dev) for x in xs], dim=dim))
        note_collective("all-gather", {e: sum(_nbytes(x) for r, x in enumerate(xs) if r != j)
                                       for j, e in enumerate(grp.ents)})
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        grp, dim = ctx.grp, ctx.dim
        got = [(j, d) for j, d in enumerate(douts) if d is not None]
        grads, each = [], {}
        for r, (lo, hi) in enumerate(ctx.ranges):
            with grp.on(r):
                parts = [d.narrow(dim, lo, hi - lo) for _, d in got]
                grads.append(_rank_sum([p.to(grp.device(r)) for p in parts]).clone()
                             if parts else None)
            each[grp.ents[r]] = sum(_nbytes(p) for (j, _), p in zip(got, parts) if j != r)
        note_collective("reduce-scatter", each)
        return (None, None, None, *grads)


class _SeqScatter(torch.autograd.Function):
    """Sequence parallelism's reduce-scatter: rank ``j`` takes range ``j``
    along ``dim`` of the present parts' sum, in rank order; the backward
    all-gathers the cotangents (each part takes the whole one)."""

    @staticmethod
    def forward(ctx, grp, ranges, dim, present, *parts):
        ctx.grp, ctx.ranges, ctx.dim, ctx.present = grp, ranges, dim, present
        ctx.shape, ctx.dtype = parts[0].shape, parts[0].dtype
        outs, each = [], {}
        for j, (lo, hi) in enumerate(ranges):
            with grp.on(j):
                dev = grp.device(j)
                pieces_ = [p.narrow(dim, lo, hi - lo).to(dev) for p in parts]
                outs.append(_rank_sum(pieces_).clone())
            each[grp.ents[j]] = sum(_nbytes(p) for r, p in zip(present, pieces_) if r != j)
        note_collective("reduce-scatter", each)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        grp, dim = ctx.grp, ctx.dim
        filled = []
        for j, (lo, hi) in enumerate(ctx.ranges):
            d = douts[j]
            if d is None:
                shape = list(ctx.shape)
                shape[dim] = hi - lo
                d = torch.zeros(shape, dtype=ctx.dtype, device=grp.device(j))
            filled.append(d)
        grads = []
        for r in ctx.present:
            with grp.on(r):
                dev = grp.device(r)
                grads.append(torch.cat([d.to(dev) for d in filled], dim=dim))
        note_collective("all-gather", {grp.ents[r]: sum(_nbytes(d) for j, d in enumerate(filled)
                                                        if j != r) for r in ctx.present})
        return (None, None, None, None, *grads)


def group_sum(grp: Group, parts: list) -> list:
    """Megatron's g over ``grp``: ``parts`` (one per rank, None for a rank
    that contributes nothing) summed in rank order, a copy on every rank;
    differentiable (each part's gradient is its rank's cotangent)."""
    present = tuple(r for r, p in enumerate(parts) if p is not None)
    return list(_GroupSum.apply(grp, present, *(parts[r] for r in present)))


def group_copy(grp: Group, xs: list) -> list:
    """Megatron's f over ``grp``: the ranks' tensors as they are; in the
    backward each takes the sum of every rank's cotangent, in rank order."""
    return list(_GroupCopy.apply(grp, *xs))


def seq_gather(grp: Group, xs: list, ranges: list, dim: int = 1) -> list:
    """The ranks' ``ranges`` of a tensor along ``dim`` (``xs[r]`` rank
    ``r``'s) concatenated on every rank; differentiable (a reduce-scatter
    in the backward)."""
    return list(_SeqGather.apply(grp, tuple(ranges), dim, *xs))


def seq_scatter(grp: Group, parts: list, ranges: list, dim: int = 1) -> list:
    """Rank ``j``'s range ``ranges[j]`` along ``dim`` of the sum of
    ``parts`` (None: nothing from that rank) in rank order; differentiable
    (an all-gather in the backward)."""
    present = tuple(r for r, p in enumerate(parts) if p is not None)
    return list(_SeqScatter.apply(grp, tuple(ranges), dim, present,
                                  *(parts[r] for r in present)))


def group_psum(grp: Group, parts: list) -> list:
    """``parts`` (None: nothing from that rank) summed over ``grp`` in rank
    order, a copy on every rank, where each rank goes on with its own share
    of the work (not the same work: Megatron's g would hand each part only
    its rank's cotangent): the backward sums every rank's cotangent in rank
    order too (:func:`group_copy` of :func:`group_sum`)."""
    return group_copy(grp, group_sum(grp, parts))


def _moved(x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    y = x.to(dev)
    return x.view_as(x) if y is x else y


class _AllToAll(torch.autograd.Function):
    """Rank ``r``'s piece for rank ``j`` moved onto ``j``'s device, for
    every pair; the backward moves each cotangent back (its transpose)."""

    @staticmethod
    def forward(ctx, grp, m, *pieces):
        ctx.grp, ctx.m = grp, m
        outs = []
        for i, x in enumerate(pieces):
            with grp.on(i % m):
                outs.append(_moved(x, grp.device(i % m)))
        note_collective("all-to-all", {e: sum(_nbytes(pieces[r * m + j]) for r in range(m)
                                              if r != j) for j, e in enumerate(grp.ents)})
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        grp, m = ctx.grp, ctx.m
        grads = []
        for i, d in enumerate(douts):
            with grp.on(i // m):
                grads.append(None if d is None else _moved(d, grp.device(i // m)))
        note_collective("all-to-all", {e: sum(_nbytes(douts[r * m + j]) for j in range(m)
                                              if j != r and douts[r * m + j] is not None)
                                       for r, e in enumerate(grp.ents)})
        return (None, None, *grads)


def all_to_all(grp: Group, pieces: list) -> list:
    """The group's all-to-all: ``pieces[r][j]`` rank ``r``'s tensor for rank
    ``j``; returns ``got[j][r]``, each on rank ``j``'s device; differentiable
    (the backward is the transposed exchange). Counted as ``"all-to-all"``:
    per rank the bytes it takes in from the others."""
    m = len(grp.ents)
    flat = _AllToAll.apply(grp, m, *(pieces[r][j] for r in range(m) for j in range(m)))
    return [[flat[r * m + j] for r in range(m)] for j in range(m)]
