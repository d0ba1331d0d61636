"""Compile-time core-grid partitioner: one network cut into fixed-budget
cores that exchange spikes, bit for bit the unpartitioned engine.

The paper's RP2350 runs the whole feature set inside 8.477 MB; the
TrueNorth/Loihi lineage scales the same way, many fixed-size cores, each
holding a slab of neurons and every synapse that targets them, exchanging
spikes every tick. The reference's ``repro/core/partition.py`` on the port:

* :func:`plan_partition` cuts the neuron axis ``[0, N)`` into contiguous
  per-core ranges under a byte budget (or into a fixed core count), then
  derives for each core its own ``NetStatic``/``NetParams`` pair (its own
  delay ring, its slice of every bucket and CSR table, its own
  :class:`~repro_torch.memory.ledger.MemoryLedger` child that enforces the
  per-core ceiling) and a spike-exchange plan (which global spike ids each
  core imports, and the bytes per tick on every core-to-core edge). The
  plan, cut for cut and byte for byte, is the reference's.

* The **key invariant**: a core's bucket is a column slice of the global
  bucket plan, never re-planned. It keeps the full global pre union, in
  the core's compact import ("ext") coordinates, and slices only the post
  axis, so every f32 sum regroups exactly as in the unpartitioned engine.
  Post coordinates never index the spike row, so a core's propagation
  (:func:`repro_torch.core.backend.propagate_packed`) reads only its
  import row; its launchers take that row's length (``n_pre``). A core's
  static drops ``backend="fused"`` to the default backend, as the
  reference's drops to ``"xla"``: a partitioned fused net runs each core
  on the per-phase launchers, never ``fused_tick``.

* Two lowerings of one plan, both Python tick loops as ``engine.run`` is,
  each core's launchers built once per run: :func:`run_partitioned` runs
  every core on the state's device (phase A on every core, each core's
  ``izh4_update`` writing its spikes straight into its ``[lo, hi)`` view
  of one global spike row; then phase B on every core off its import
  row), and :func:`run_partitioned_mesh` places core c on entry c of a
  device-list mesh (:func:`repro_torch.core.distributed.core_mesh`), its
  spikes in its slot of a flat row padded to the widest core, one
  all-gather of the slots per tick onto every distinct device, and the
  precomputed flat index tables reading the import rows from it. Both run
  the same per-core phases, so mesh ≡ sequential ≡ unpartitioned.

Scope (a typed :class:`PartitionError` otherwise), the reference's:
plastic and STP projections never split across cores (each plasticity
cluster, its pre and post groups closed under contiguity, is atomic); the
mesh lowering takes current-based, non-plastic networks; homeostasis,
``propagation="loop"``, lanes and in-run monitors stay on the
single-program engine.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import backend as be
from repro_torch.core import rng
from repro_torch.core.conductance import ConductanceState, decay_factors
from repro_torch.core.distributed import DeviceMesh, core_mesh, device_context
from repro_torch.core.engine import _final_syn, _gen_spikes, _neuron_phase, _plasticity, _Syn
from repro_torch.core.engine import _stdp_launchers
from repro_torch.core.network import BucketSpec, GroupSpec, NetParams, NetState, NetStatic
from repro_torch.core.network import _to_device
from repro_torch.core.neurons import NeuronState
from repro_torch.memory.ledger import MCU_BUDGET_BYTES, MemoryBudgetError

__all__ = [
    "PartitionError",
    "PartitionSpec",
    "CorePlan",
    "ExchangePlan",
    "PartitionPlan",
    "plan_partition",
    "run_partitioned",
    "run_partitioned_mesh",
]

f32 = torch.float32


class PartitionError(ValueError):
    """A network cannot be cut under the requested partition spec (atom
    over budget, plastic cluster split, unsupported feature, ...)."""


@dataclasses.dataclass(frozen=True)
class PartitionSpec:
    """The partition request (``network.compile(partition=...)``).

    One sizing mode: ``n_cores`` fixes the core count (a byte-balanced
    cut), else ``core_budget_bytes`` packs greedily under the per-core
    ceiling (default: the paper's 8.477 MB MCU budget). With both,
    ``n_cores`` drives the cut and the budget still holds on every core's
    ledger. ``lowering`` is ``"sequential"`` (every core on one device) or
    ``"mesh"`` (core c on entry c of a device-list mesh along
    ``mesh_axis``). ``split_groups=False`` cuts at group boundaries only.
    ``fill_frac`` is the greedy packer's target fill of the budget; the
    budget itself stays the hard ceiling of every core's ledger.
    """

    n_cores: int | None = None
    core_budget_bytes: int | None = MCU_BUDGET_BYTES
    lowering: str = "sequential"
    mesh_axis: str = "cores"
    split_groups: bool = True
    fill_frac: float = 0.85


class _ProjCut(NamedTuple):
    """How one global projection maps into a core: ``kind`` is ``"full"``
    (intact: a plastic or STP projection's owner core), ``"csr_rows"`` (CSR
    weight and index rows ``[c0:c1]``) or ``"dense_cols"`` (dense weight
    columns ``[:, c0:c1]``); ``mutable`` marks weights the core rewrites
    (reassembly reads them back from the owner)."""

    gj: int
    kind: str
    c0: int
    c1: int
    mutable: bool


@dataclasses.dataclass(frozen=True)
class CorePlan:
    """One core: neurons ``[lo, hi)`` of the global index space, a per-core
    ``NetStatic`` whose pre coordinates live in the core's import ("ext")
    space, the projection cuts, the core's generator-uniform columns
    ``[gc0, gc1)``, and its verified ledger bytes."""

    index: int
    lo: int
    hi: int
    static: NetStatic
    proj_cuts: tuple[_ProjCut, ...]
    gc0: int
    gc1: int
    n_ext: int
    bytes_total: int


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Inter-core spike traffic: ``edges`` holds ``(src, dst, n_ids)`` for
    every core pair where ``dst`` imports ``n_ids`` of ``src``'s spikes;
    ``bytes_per_tick`` counts 1 byte per imported spike flag per tick."""

    edges: tuple[tuple[int, int, int], ...]
    bytes_per_tick: int


@dataclasses.dataclass(eq=False)
class PartitionPlan:
    """The compiled partition: the cores, the exchange, each core's params
    and import table (``ext_idx``: int64 global ids on the net's device;
    ``ext_ids`` the host copy) and each core's ledger."""

    spec: PartitionSpec
    n: int
    cores: tuple[CorePlan, ...]
    exchange: ExchangePlan
    params: tuple[NetParams, ...]
    ext_idx: tuple[torch.Tensor, ...]
    ext_ids: tuple[np.ndarray, ...]
    ledgers: tuple = ()

    @property
    def n_cores(self) -> int:
        return len(self.cores)

    @property
    def run_params(self):
        """The operands of the partitioned runners."""
        return (self.params, self.ext_idx)

    def core_bytes(self) -> dict[int, int]:
        return {cp.index: cp.bytes_total for cp in self.cores}


# ---------------------------------------------------------------------------
# planning


def _leaves(tree):
    """The tensors of a nested NamedTuple/tuple tree, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, tuple):
        for x in tree:
            yield from _leaves(x)


def _map(fn, tree):
    """``fn`` over every tensor of a NamedTuple tree."""
    return type(tree)(*(fn(x) for x in tree))


def _group_index(groups, start: int, size: int, what: str) -> int:
    for gi, g in enumerate(groups):
        if g.start <= start and start + size <= g.start + g.size:
            return gi
    raise PartitionError(f"{what}: span [{start}, {start + size}) does not "
                         "lie inside any group")


def _atomic_spans(static: NetStatic) -> list[tuple[int, int, str]]:
    """Neuron spans that must stay inside one core: each plastic or STP
    cluster's groups, closed under union-find and contiguity (a core is a
    contiguous range, so a cluster spanning groups 2 and 5 pins 3 and 4)."""
    groups = static.groups
    parent = list(range(len(groups)))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra

    constrained: set[int] = set()
    for s in static.projections:
        if not (s.plastic or s.stp is not None):
            continue
        gp = _group_index(groups, s.pre_start, s.pre_size, s.name)
        gq = _group_index(groups, s.post_start, s.post_size, s.name)
        union(gp, gq)
        constrained.add(find(gp))
    changed = True
    while changed:  # widen every cluster to its whole group interval
        changed = False
        constrained = {find(r) for r in constrained}
        for r in list(constrained):
            members = [gi for gi in range(len(groups)) if find(gi) == r]
            for gi in range(min(members), max(members) + 1):
                if find(gi) != find(r):
                    union(r, gi)
                    changed = True
        constrained = {find(r) for r in constrained}
    spans = []
    for r in constrained:
        members = [gi for gi in range(len(groups)) if find(gi) == r]
        lo_g, hi_g = groups[min(members)], groups[max(members)]
        names = ", ".join(groups[gi].name for gi in members)
        spans.append((lo_g.start, hi_g.start + hi_g.size, names))
    return sorted(spans)


def _byte_density(static: NetStatic, params: NetParams, state: NetState) -> np.ndarray:
    """Per-neuron device bytes, mirroring what each core's ledger will
    register: the cut's cost model (the authoritative check registers the
    real per-core tensors afterwards)."""
    n = static.n
    rho = np.zeros(n, np.float64)
    sdt = state.neurons.v.element_size()
    # generator schedule rows (3 × f32), neuron state v/u + refrac,
    # conductances, per-neuron model params, delay ring
    rho += 12.0
    rho += 2 * sdt + 2
    if state.cond is not None:
        rho += 2 * sdt
    rho += sum(x.element_size() for x in _leaves(params.neuron))
    rho += static.ring_len * static.ring_channels * sdt
    csr_projs = static.csr_projs
    for j, s in enumerate(static.projections):
        w = state.weights[j]
        wdt = w.element_size()
        post = slice(s.post_start, s.post_start + s.post_size)
        pre = slice(s.pre_start, s.pre_start + s.pre_size)
        if j in csr_projs:
            f = w.shape[1]
            rho[post] += f * (wdt + params.proj_csr_idx[j].element_size())
            if s.plastic:
                rho[post] += f  # validity rows
        else:
            rho[post] += s.pre_size * wdt
            if s.plastic:
                rho[post] += s.pre_size  # dense bool mask
                t = params.proj_csr_idx[j]
                if t is not None:
                    rho[post] += t.shape[1] * t.element_size()
        if s.stp is not None:
            rho[pre] += 2 * sdt
        tr = state.stdp[j]
        if tr is not None:
            for leaf in _leaves(tr):
                per = leaf.element_size()
                if leaf.dim() == 1 and leaf.shape[0] == s.pre_size:
                    rho[pre] += per
                else:  # post traces and eligibility count on the post neurons
                    rho[post] += (leaf.numel() // max(s.post_size, 1)) * per
    return rho


def _cut_points(static: NetStatic, spec: PartitionSpec, rho: np.ndarray,
                eff_budget: float | None) -> list[int]:
    """Core boundaries over the neuron axis: a greedy fill under
    ``eff_budget``, or a byte-balanced ``n_cores`` snap, both restricted to
    the allowed cut positions (outside atomic spans; group boundaries only
    when ``split_groups=False``)."""
    n = static.n
    allowed = np.ones(n + 1, bool)
    if not spec.split_groups:
        allowed[:] = False
        for g in static.groups:
            allowed[g.start] = True
        allowed[n] = True
    allowed[0] = False
    spans = _atomic_spans(static)
    for a, b, _names in spans:
        allowed[a + 1:b] = False
    cum = np.concatenate([[0.0], np.cumsum(rho)])

    def atom_at(i: int) -> tuple[int, int, str]:
        for a, b, names in spans:
            if a <= i < b:
                return a, b, names
        return i, i + 1, "(single neuron)"

    if spec.n_cores is not None:
        k = spec.n_cores
        if k < 1:
            raise PartitionError(f"n_cores must be >= 1, got {k}")
        if not spec.split_groups and k > len(static.groups):
            raise PartitionError(
                f"n_cores={k} exceeds the {len(static.groups)} groups and "
                "split_groups=False forbids cutting inside a group")
        cuts = [0]
        cand = np.flatnonzero(allowed)
        for c in range(1, k):
            target = cum[-1] * c / k
            pos = np.searchsorted(cum[cand], target)
            best = None
            for p in (pos - 1, pos, pos + 1):
                if 0 <= p < cand.size and cand[p] > cuts[-1] and cand[p] < n - (k - 1 - c):
                    d = abs(cum[cand[p]] - target)
                    if best is None or d < best[0]:
                        best = (d, int(cand[p]))
            if best is None:
                # the first allowed position past the previous cut
                later = cand[(cand > cuts[-1]) & (cand < n)]
                if later.size == 0:
                    raise PartitionError(
                        f"cannot place {k} cores: only {len(cuts)} feasible cut(s) — "
                        "atomic plasticity spans leave too few boundaries")
                best = (0.0, int(later[0]))
            cuts.append(best[1])
        cuts.append(n)
        if len(set(cuts)) != k + 1:
            raise PartitionError(
                f"cannot place {k} distinct cores over {n} neurons with the allowed "
                "cut positions")
        return cuts

    assert eff_budget is not None
    cuts = [0]
    lo = 0
    while lo < n:
        hi_max = int(np.searchsorted(cum, cum[lo] + eff_budget, side="right")) - 1
        if hi_max >= n:
            cuts.append(n)
            break
        h = hi_max
        while h > lo and not allowed[h]:
            h -= 1
        if h <= lo:
            a, b, names = atom_at(lo if hi_max <= lo else hi_max)
            need = cum[b] - cum[a]
            if need <= float(spec.core_budget_bytes) and b > lo:
                # The atom overflows the fill target but fits the hard
                # ceiling: it is indivisible, so take it whole (the ledger
                # check still enforces the budget).
                cuts.append(b)
                lo = b
                continue
            raise PartitionError(
                f"core budget {spec.core_budget_bytes / 1024**2:.3f} MB cannot hold the "
                f"atomic span [{a}, {b}) ({names}): it needs ~{need / 1024**2:.3f} MB — "
                "raise the budget or break the plasticity cluster")
        cuts.append(h)
        lo = h
    return cuts


def _bucket_arrays(params: NetParams, bi: int, b: BucketSpec):
    """Global (pres, posts) id arrays of bucket ``bi``."""
    if b.pre_start >= 0:
        pres = np.arange(b.pre_start, b.pre_start + b.p)
    else:
        pres = params.bucket_pre_ids[bi].cpu().numpy().astype(np.int64)
    if b.post_start >= 0:
        posts = np.arange(b.post_start, b.post_start + b.q)
    else:
        posts = params.bucket_post_ids[bi].cpu().numpy().astype(np.int64)
    return pres, posts


def _build_core(static: NetStatic, params: NetParams, lo: int, hi: int):
    """One core's (NetStatic, NetParams, proj_cuts, ext ids, gen-column
    range). Pre coordinates of the returned static and params live in the
    core's ext space; post coordinates are core-local."""
    csr_projs = static.csr_projs
    specs = static.projections
    dev = params.gen_rate.device

    # -- which projections land here, and how --------------------------------
    proj_map: list[int] = []
    proj_cuts: list[_ProjCut] = []
    for j, s in enumerate(specs):
        if s.plastic or s.stp is not None:
            if s.post_start >= lo and s.post_start + s.post_size <= hi:
                if not (s.pre_start >= lo and s.pre_start + s.pre_size <= hi):
                    raise PartitionError(
                        f"plastic/STP projection {s.name} spans cores — the cut must keep "
                        "its cluster intact")
                proj_map.append(j)
                proj_cuts.append(_ProjCut(j, "full", 0, s.post_size,
                                          mutable=(static.stdp[j] is not None
                                                   or s.stp is not None)))
            elif not (s.post_start + s.post_size <= lo or s.post_start >= hi):
                raise PartitionError(
                    f"plastic/STP projection {s.name} split by the cut at [{lo}, {hi}) — "
                    "plan_partition must not produce this")
            continue
        c0 = max(s.post_start, lo) - s.post_start
        c1 = min(s.post_start + s.post_size, hi) - s.post_start
        if c1 <= c0:
            continue
        proj_map.append(j)
        proj_cuts.append(_ProjCut(j, "csr_rows" if j in csr_projs else "dense_cols",
                                  c0, c1, mutable=False))

    # -- ext space: every global pre id a kept table reads --------------------
    need: list[np.ndarray] = []
    kept = []
    for bi, b in enumerate(static.buckets):
        pres, posts = _bucket_arrays(params, bi, b)
        s_ = int(np.searchsorted(posts, lo))
        e_ = int(np.searchsorted(posts, hi))
        if e_ <= s_:
            continue
        kept.append((bi, b, pres, posts, s_, e_))
        need.append(pres)
    for cut in proj_cuts:
        if cut.kind == "full":
            s = specs[cut.gj]
            need.append(np.arange(s.pre_start, s.pre_start + s.pre_size))
    ext = np.unique(np.concatenate(need)) if need else np.zeros((0,), np.int64)

    def ext_pos(gid: int) -> int:
        return int(np.searchsorted(ext, gid))

    # A CSR projection's index table is one tensor in bucket_csr_idx and in
    # proj_csr_idx; slice it once per (table, range) so the core's params
    # keep the alias and its ledger counts the rows once.
    slices: dict[tuple[int, int, int], torch.Tensor] = {}

    def row_slice(table, a, b_):
        key = (id(table), a, b_)
        if key not in slices:
            slices[key] = table[a:b_]
        return slices[key]

    # -- per-core group slices -----------------------------------------------
    groups_c: list[GroupSpec] = []
    for g in static.groups:
        a, b_ = max(g.start, lo), min(g.start + g.size, hi)
        if b_ <= a:
            continue
        groups_c.append(dataclasses.replace(g, start=a - lo, size=b_ - a))
    gen_sorted = [(g.start, g.size) for g in static.groups if g.is_generator]
    gc0 = sum(min(sz, max(0, min(g0 + sz, lo) - g0)) for g0, sz in gen_sorted)
    gc1 = sum(min(sz, max(0, min(g0 + sz, hi) - g0)) for g0, sz in gen_sorted)

    # -- per-core projection specs, masks and index tables -------------------
    specs_c, masks_c, proj_idx_c = [], [], []
    for cut in proj_cuts:
        s = specs[cut.gj]
        if cut.kind == "full":
            specs_c.append(dataclasses.replace(s, pre_start=ext_pos(s.pre_start),
                                               post_start=s.post_start - lo))
            masks_c.append(params.masks[cut.gj])
            proj_idx_c.append(params.proj_csr_idx[cut.gj])
        else:
            specs_c.append(dataclasses.replace(
                s, pre_start=ext_pos(s.pre_start), post_start=max(s.post_start, lo) - lo,
                post_size=cut.c1 - cut.c0))
            masks_c.append(None)  # never read on the non-plastic path
            t = params.proj_csr_idx[cut.gj]
            proj_idx_c.append(None if t is None else row_slice(t, cut.c0, cut.c1))

    # -- per-core buckets: post slices of the global plan --------------------
    empty = torch.zeros((0,), dtype=torch.int32, device=dev)
    buckets_c, bpre_c, bpost_c, bidx_c = [], [], [], []
    local_j = {gj: lj for lj, gj in enumerate(proj_map)}
    for bi, b, pres, posts, s_, e_ in kept:
        posts_c = posts[s_:e_]
        q_c = e_ - s_
        members = []
        for (j, r0, c0) in b.members:
            qj = specs[j].post_size
            ms, me = max(c0, s_), min(c0 + qj, e_)
            if me <= ms:
                continue
            members.append((local_j[j], r0, ms - s_))
        post_contig = int(posts_c[-1]) - int(posts_c[0]) + 1 == q_c
        if b.pre_start >= 0:
            pre_start_c = ext_pos(b.pre_start)
            bpre_c.append(empty)
        else:
            pre_start_c = -1
            bpre_c.append(torch.from_numpy(
                np.searchsorted(ext, pres).astype(np.int32)).to(dev))
        buckets_c.append(dataclasses.replace(
            b, q=q_c, pre_start=pre_start_c,
            post_start=int(posts_c[0]) - lo if post_contig else -1,
            members=tuple(members)))
        bpost_c.append(empty if post_contig
                       else torch.from_numpy((posts_c - lo).astype(np.int32)).to(dev))
        gi = params.bucket_csr_idx[bi]
        bidx_c.append(None if gi is None else row_slice(gi, s_, e_))

    static_c = dataclasses.replace(
        static,
        n=hi - lo,
        groups=tuple(groups_c),
        projections=tuple(specs_c),
        stdp=tuple(static.stdp[cut.gj] for cut in proj_cuts),
        backend=None,
        buckets=tuple(buckets_c),
        plastic_csr=tuple(sorted(local_j[j] for j in static.plastic_csr if j in local_j)),
        stp_csr=tuple(sorted(local_j[j] for j in static.stp_csr if j in local_j)),
        fused=None,
        monitors=(),
        watches=(),
        homeo=tuple(None for _ in proj_cuts),
        homeo_period=0,
    )
    params_c = NetParams(
        neuron=_map(lambda x: x[lo:hi], params.neuron),
        masks=tuple(masks_c),
        gen_rate=params.gen_rate[lo:hi],
        gen_until=params.gen_until[lo:hi],
        gen_rate_after=params.gen_rate_after[lo:hi],
        bucket_pre_ids=tuple(bpre_c),
        bucket_post_ids=tuple(bpost_c),
        bucket_csr_idx=tuple(bidx_c),
        proj_csr_idx=tuple(proj_idx_c),
    )
    return static_c, params_c, tuple(proj_cuts), ext, gc0, gc1


class _CoreState(NamedTuple):
    neurons: NeuronState
    ring: torch.Tensor
    cond: ConductanceState | None
    weights: tuple
    stp: tuple
    stdp: tuple


def _split_state(cores, state: NetState) -> tuple[_CoreState, ...]:
    """A global NetState sliced into per-core states (views)."""
    out = []
    for cp in cores:
        lo, hi = cp.lo, cp.hi
        ws, stps, stdps = [], [], []
        for cut in cp.proj_cuts:
            w = state.weights[cut.gj]
            if cut.kind == "full":
                ws.append(w)
                stps.append(state.stp[cut.gj])
                stdps.append(state.stdp[cut.gj])
            else:
                ws.append(w[cut.c0:cut.c1] if cut.kind == "csr_rows" else w[:, cut.c0:cut.c1])
                stps.append(None)
                stdps.append(None)
        out.append(_CoreState(
            neurons=_map(lambda x: x[lo:hi], state.neurons), ring=state.ring[:, lo:hi],
            cond=None if state.cond is None else _map(lambda x: x[lo:hi], state.cond),
            weights=tuple(ws), stp=tuple(stps), stdp=tuple(stdps)))
    return tuple(out)


def _register_core_ledger(parent, index: int, params_c: NetParams, core: _CoreState,
                          ext: np.ndarray, budget):
    """The authoritative per-core sizing: the core's real tensors on a child
    ledger under the compile stages (raises MemoryBudgetError over
    budget)."""
    led = parent.child(f"core{index}", budget=budget)
    with led.stage("2. Random Gen."):
        led.register("rng", (params_c.gen_rate, params_c.gen_until, params_c.gen_rate_after))
    with led.stage("3. Conn. Info"):
        masks = tuple(m for m in params_c.masks if m is not None)
        if masks:
            led.register("masks", masks)
        seen: dict[int, torch.Tensor] = {}
        for t in (params_c.bucket_csr_idx + params_c.proj_csr_idx
                  + params_c.bucket_pre_ids + params_c.bucket_post_ids):
            if t is not None and t.numel() and id(t) not in seen:
                seen[id(t)] = t
        if seen:
            led.register("csr.indices", tuple(seen.values()))
        if ext.size:
            led.register("exchange.import",
                         torch.empty((ext.size,), dtype=torch.int32, device="meta"))
    with led.stage("4. Syn. State"):
        led.register("weights", core.weights)
        led.register("ring", core.ring)
        stp = tuple(s for s in core.stp if s is not None)
        if stp:
            led.register("stp", stp)
    with led.stage("5. Neuron State"):
        led.register("neuron.state", core.neurons)
        if core.cond is not None:
            led.register("conductances", core.cond)
    with led.stage("6. Group State"):
        led.register("neuron.params", params_c.neuron)
    with led.stage("7. Auxiliary Data"):
        tr = tuple(s for s in core.stdp if s is not None)
        if tr:
            led.register("stdp.traces", tr)
    return led


def plan_partition(net, spec: PartitionSpec) -> PartitionPlan:
    """Cut ``net`` (a CompiledNetwork) into cores per ``spec``.

    Checks the feature scope, cuts the neuron axis under the byte budget
    (or into ``n_cores``), derives every core's static, params and import
    table, verifies each core on a child ledger (retrying with a fill
    target tightened by 0.95 where the density model under-counted, up to
    four cuts), and publishes the plan through :mod:`repro_torch.obs` (the
    ``partition_plan`` span, ``repro_partition_core_bytes{core}``,
    ``repro_partition_cores`` and
    ``repro_partition_exchange_bytes_per_tick``)."""
    static, params, state = net.static, net.params, net.state0
    if spec.n_cores is None and spec.core_budget_bytes is None:
        raise PartitionError("PartitionSpec needs n_cores or core_budget_bytes")
    if spec.lowering not in ("sequential", "mesh"):
        raise PartitionError(f"unknown lowering {spec.lowering!r}")
    if static.propagation == "loop":
        raise PartitionError(
            "propagation='loop' cannot be partitioned — the oracle has no bucket plan "
            "to slice; use packed/sparse/auto")
    if static.homeo_period or any(h is not None for h in static.homeo):
        raise PartitionError(
            "homeostasis is not supported under partitioning — the slow timer would "
            "need a cross-core spike-count reduction")
    if spec.lowering == "mesh":
        if any(s.plastic or s.stp is not None for s in static.projections):
            raise PartitionError(
                "lowering='mesh' covers non-plastic networks — plastic/STP cores run "
                "under lowering='sequential'")
        if static.coba is not None:
            raise PartitionError(
                "lowering='mesh' does not support conductance (COBA) networks")

    with obs.span("partition_plan", n=static.n, lowering=spec.lowering,
                  n_cores=spec.n_cores or 0, budget=float(spec.core_budget_bytes or 0)):
        rho = _byte_density(static, params, state)
        eff = (float(spec.core_budget_bytes) * spec.fill_frac
               if spec.core_budget_bytes else None)
        last_err: Exception | None = None
        for _attempt in range(4):
            cuts = _cut_points(static, spec, rho, None if spec.n_cores is not None else eff)
            try:
                plan = _materialize(net, spec, cuts)
                break
            except MemoryBudgetError as e:
                last_err = e
                if spec.n_cores is not None or eff is None:
                    raise PartitionError(f"a core exceeds the per-core budget: {e}") from e
                eff *= 0.95  # the density under-counted: tighten the fill
        else:
            raise PartitionError(
                f"could not fit cores under {spec.core_budget_bytes / 1024**2:.3f} MB "
                f"after retries: {last_err}") from last_err

    for cp in plan.cores:
        obs.gauge("repro_partition_core_bytes", float(cp.bytes_total), core=str(cp.index))
    obs.gauge("repro_partition_cores", float(plan.n_cores))
    obs.gauge("repro_partition_exchange_bytes_per_tick",
              float(plan.exchange.bytes_per_tick))
    return plan


def _materialize(net, spec: PartitionSpec, cuts: list[int]) -> PartitionPlan:
    static, params, state = net.static, net.params, net.state0
    pending = []
    for ci in range(len(cuts) - 1):
        lo, hi = cuts[ci], cuts[ci + 1]
        static_c, params_c, proj_cuts, ext, gc0, gc1 = _build_core(static, params, lo, hi)
        pending.append((ci, lo, hi, static_c, params_c, proj_cuts, ext, gc0, gc1))
    probe = [CorePlan(ci, lo, hi, static_c, proj_cuts, gc0, gc1, ext.size, 0)
             for ci, lo, hi, static_c, _p, proj_cuts, ext, gc0, gc1 in pending]
    split = _split_state(probe, state)
    cores, params_l, ext_l, ext_np, ledgers = [], [], [], [], []
    dev = state.ring.device
    for ci, lo, hi, static_c, params_c, proj_cuts, ext, gc0, gc1 in pending:
        led = _register_core_ledger(net.ledger, ci, params_c, split[ci], ext,
                                    spec.core_budget_bytes)
        ledgers.append(led)
        cores.append(CorePlan(ci, lo, hi, static_c, proj_cuts, gc0, gc1, int(ext.size),
                              int(led.total_used)))
        params_l.append(params_c)
        ext_l.append(torch.from_numpy(ext.astype(np.int64)).to(dev))
        ext_np.append(ext)

    # the exchange plan: who imports whose spikes
    edges: dict[tuple[int, int], int] = {}
    for cp, ext in zip(cores, ext_np):
        if not ext.size:
            continue
        owner = np.searchsorted(np.asarray(cuts), ext, side="right") - 1
        for src in np.unique(owner):
            if int(src) == cp.index:
                continue
            edges[(int(src), cp.index)] = int((owner == src).sum())
    exchange = ExchangePlan(edges=tuple((s, d, n_) for (s, d), n_ in sorted(edges.items())),
                            bytes_per_tick=int(sum(edges.values())))
    return PartitionPlan(spec=spec, n=static.n, cores=tuple(cores), exchange=exchange,
                         params=tuple(params_l), ext_idx=tuple(ext_l), ext_ids=tuple(ext_np),
                         ledgers=tuple(ledgers))


# ---------------------------------------------------------------------------
# execution: per-core launchers and phases, shared by both lowerings


class _Core:
    """One core's run: its state (copies on ``device``), its launchers,
    built once per run, and its two phases per tick. ``spikes`` is the
    ``[n_c]`` f32 view its spike row lands in, ``pre_row()`` its import
    row."""

    def __init__(self, cp: CorePlan, par: NetParams, core: _CoreState, gen_spk, raster,
                 spikes: torch.Tensor, import_row, local_pre: dict):
        cs = cp.static
        self.cp, self.cs, self.par = cp, cs, par
        self.spikes, self.import_row = spikes, import_row
        self.raster = raster
        self.ring = core.ring.clone(memory_format=torch.contiguous_format)
        self.neurons, self.cond = core.neurons, core.cond
        self.gen_spk = gen_spk
        self.decays = None if cs.coba is None else decay_factors(cs.coba, cs.dt)
        self.neuron_run = be.assemble_neurons(
            cs, par, core.neurons, self.ring, cond=core.cond, gen_spk=gen_spk,
            raster=raster, spikes=spikes)
        # Plasticity reads the core's own row: its projections' pre spans in
        # core-local coordinates.
        self.local = dataclasses.replace(cs, projections=tuple(
            dataclasses.replace(s, pre_start=local_pre[lj]) if lj in local_pre else s
            for lj, s in enumerate(cs.projections)))
        syn = _Syn(core.weights, core.stp, core.stdp)
        self.stdp_runs, self.padded, weights = _stdp_launchers(self.local, par, syn)
        self.syn = _Syn(weights, core.stp, core.stdp)
        n_ext = cp.n_ext
        self.packed = be.assemble_packed(cs, weights)
        self.fanin = be.assemble_fanin(cs, par, n_ext)
        self.matmul = be.assemble_matmul(cs, self.packed)
        self.gather = be.assemble_gather(cs, par, self.packed, n_pre=n_ext)
        self.drive = be.assemble_drive(cs, par, weights, core.stp, self.gather, self.fanin,
                                       n_pre=n_ext)

    def phase_a(self, i: int, t: int) -> None:
        """Ring slot read and zeroed, COBA, the neuron phase, the generator
        merge: the core's spikes into its view of the spike row."""
        if self.neuron_run is not None:
            self.neuron_run(i, t)
            return
        self.neurons, spikes, _, self.cond = _neuron_phase(
            self.cs, self.par, self.neurons, self.ring, t,
            None if self.gen_spk is None else self.gen_spk[i], None, self.cond, self.decays)
        self.spikes.copy_(spikes)
        if self.raster is not None:
            self.raster[i] = spikes

    def phase_b(self, t: int) -> None:
        """Propagation off the import row; the core's plasticity off its
        own row."""
        pre = self.import_row()
        stp = be.propagate_packed(self.cs, self.par, pre, self.ring, t, self.packed,
                                  self.syn.weights, self.syn.stp, self.fanin, self.matmul,
                                  self.gather, self.padded, None, self.drive)
        weights, stdp = _plasticity(self.local, self.par, self.spikes, self.syn.weights,
                                    self.syn.stdp, None, self.stdp_runs)
        self.syn = _Syn(weights, stp, stdp)

    def final(self, device) -> _CoreState:
        """The core's final state, on ``device``."""
        if self.neuron_run is not None:
            nr = self.neuron_run
            self.neurons = NeuronState(v=nr.v, u=nr.u, refrac=nr.refrac)
            self.cond = None if nr.cond is None else ConductanceState(*nr.cond)
        syn = _final_syn(self.syn, self.stdp_runs)
        return _to_device(_CoreState(self.neurons, self.ring, self.cond, syn.weights, syn.stp,
                                     syn.stdp), device)


def _check_record(record: str) -> None:
    if record not in ("raster", "none"):
        raise PartitionError(
            f"partitioned runs support record='raster'/'none', got {record!r} — "
            "in-run monitors are per-program")


def _draw(static: NetStatic, state: NetState, n_steps: int):
    """The generator draw of ``engine.run``'s whole-run path: the carry key
    split iff there are generators, ``[T, n_gen]`` uniforms."""
    if static.n_gen:
        k_draw, key = rng.split(state.key).unbind(-2)
        return key, rng.uniform(k_draw, (n_steps, static.n_gen))
    return state.key, None


def _core_gen(cp: CorePlan, par: NetParams, t0: int, gu):
    """The core's generator spikes ``[T, gc1 - gc0]`` from its columns of
    the whole-run uniforms (None for a core without generators)."""
    if gu is None or cp.gc1 == cp.gc0:
        return None
    return _gen_spikes(cp.static, par, t0, gu[:, cp.gc0:cp.gc1].contiguous())


def _reassemble(plan: PartitionPlan, state: NetState, finals, t_final: int,
                key) -> NetState:
    """The per-core final states concatenated back into one NetState."""
    neurons = NeuronState(*(torch.cat(xs) for xs in zip(*(c.neurons for c in finals))))
    ring = torch.cat([c.ring for c in finals], dim=1)
    cond = (None if state.cond is None
            else ConductanceState(*(torch.cat(xs) for xs in zip(*(c.cond for c in finals)))))
    weights, stp, stdp = list(state.weights), list(state.stp), list(state.stdp)
    for cp, cf in zip(plan.cores, finals):
        for lj, cut in enumerate(cp.proj_cuts):
            if cut.mutable:
                weights[cut.gj] = cf.weights[lj]
                stp[cut.gj] = cf.stp[lj]
                stdp[cut.gj] = cf.stdp[lj]
    return NetState(t=t_final, key=key, neurons=neurons, ring=ring, weights=tuple(weights),
                    stp=tuple(stp), stdp=tuple(stdp), cond=cond, homeo=state.homeo)


def _sequential_cores(static: NetStatic, plan: PartitionPlan, pparams, state: NetState,
                      n_steps: int, want_raster: bool):
    """The sequential lowering's set-up: the whole-run generator draw, the
    global f32 spike row on the state's device and every core's run (its
    launchers built once, its spike row a ``[lo, hi)`` view of the global
    row, its import row ``row[ext_idx]``). Returns ``(key', row, cores)``."""
    core_params, ext_idx = pparams
    dev = state.ring.device
    key, gu = _draw(static, state, n_steps)
    row = torch.zeros((static.n,), dtype=f32, device=dev)
    cores = []
    for cp, par, cst, idx in zip(plan.cores, core_params, _split_state(plan.cores, state),
                                 ext_idx):
        raster = (torch.empty((n_steps, cp.hi - cp.lo), dtype=torch.bool, device=dev)
                  if want_raster else None)
        if cp.n_ext:
            def import_row(idx=idx):
                return row.index_select(0, idx)
        else:
            def import_row():
                return row.new_zeros((0,))
        cores.append(_Core(cp, par, cst, _core_gen(cp, par, state.t, gu), raster,
                           row[cp.lo:cp.hi], import_row, _owner_starts(static, cp)))
    return key, row, cores


def run_partitioned(static: NetStatic, plan: PartitionPlan, pparams, state: NetState,
                    n_steps: int, record: str = "raster") -> tuple[NetState, dict]:
    """The sequential lowering: every core on the state's device, one tick
    loop. Per tick: phase A on every core (each core's spike row lands in
    its ``[lo, hi)`` view of one global f32 spike row), then phase B on
    every core off its import row (``spikes[ext_idx]``). Returns
    ``(final_global_state, outputs)`` as ``engine.run`` does (the raster is
    the global ``[T, N]`` bool tensor)."""
    _check_record(record)
    want_raster = record == "raster"
    key, _, cores = _sequential_cores(static, plan, pparams, state, n_steps, want_raster)
    for i in range(n_steps):
        t = state.t + i
        for core in cores:
            core.phase_a(i, t)
        for core in cores:
            core.phase_b(t)
    dev = state.ring.device
    final = _reassemble(plan, state, [c.final(dev) for c in cores], state.t + n_steps, key)
    outputs = {"spikes": torch.cat([c.raster for c in cores], dim=1)} if want_raster else {}
    return final, outputs


def _owner_starts(static: NetStatic, cp: CorePlan) -> dict[int, int]:
    """Local projection id → the core-local start of its pre group, for the
    projections the core owns whole (``"full"`` cuts: a plastic or STP
    projection lies wholly inside its core)."""
    return {lj: static.projections[cut.gj].pre_start - cp.lo
            for lj, cut in enumerate(cp.proj_cuts) if cut.kind == "full"}


def run_partitioned_mesh(static: NetStatic, plan: PartitionPlan, pparams, state: NetState,
                         n_steps: int, record: str = "raster",
                         mesh: DeviceMesh | None = None) -> tuple[NetState, dict]:
    """The mesh lowering: core c on entry c of ``mesh`` (default:
    :func:`repro_torch.core.distributed.core_mesh` with one visible card per
    core), one all-gather of the spike rows per tick.

    Each core's tensors live on its mesh device; its spike row lands in
    slot c of a flat ``[k · n_pad]`` row (``n_pad`` the widest core) on its
    device; the exchange copies every slot onto every other distinct device
    of the mesh (on one device the slots already share one row: no copy),
    and each core reads its import row from its device's flat row through
    its precomputed flat index table (global id g of core s at local offset
    r sits at ``s · n_pad + r``). The per-core phases are the sequential
    lowering's, so the two agree bit for bit. Current-based, non-plastic
    networks only (checked at plan time); the mesh's size must equal the
    core count. Returns ``(final_global_state, outputs)`` on the state's
    device, as :func:`run_partitioned`."""
    _check_record(record)
    core_params, _ = pparams
    k = plan.n_cores
    axis = plan.spec.mesh_axis
    if mesh is None:
        mesh = core_mesh(k, axis=axis)
    if axis not in mesh.shape:
        raise PartitionError(f"mesh has no axis {axis!r} (axes: {tuple(mesh.shape)})")
    if mesh.shape[axis] != k:
        raise PartitionError(f"mesh has {mesh.shape[axis]} devices but the plan has {k} "
                             "cores — they must match 1:1")
    home = state.ring.device
    n_pad = max(cp.hi - cp.lo for cp in plan.cores)
    key, gu = _draw(static, state, n_steps)
    flat = {d: torch.zeros((k * n_pad,), dtype=f32, device=d) for d in mesh.distinct}
    lows = np.asarray([cp.lo for cp in plan.cores])
    bounds = np.asarray([cp.lo for cp in plan.cores] + [plan.n])
    want_raster = record == "raster"
    cores = []
    for c, (cp, par, cst) in enumerate(zip(plan.cores, core_params,
                                           _split_state(plan.cores, state))):
        dev = mesh.devices[c]
        with device_context(dev):
            ext = plan.ext_ids[c]
            owner = np.searchsorted(bounds, ext, side="right") - 1
            fidx = torch.from_numpy((owner * n_pad + (ext - lows[owner])).astype(
                np.int64)).to(dev)
            row = flat[dev]
            if cp.n_ext:
                def import_row(row=row, fidx=fidx):
                    return row.index_select(0, fidx)
            else:
                def import_row(row=row):
                    return row.new_zeros((0,))
            par = _to_device(par, dev)
            raster = (torch.empty((n_steps, cp.hi - cp.lo), dtype=torch.bool, device=dev)
                      if want_raster else None)
            gen = _core_gen(cp, par, state.t, None if gu is None else gu.to(dev))
            cores.append(_Core(cp, par, _to_device(cst, dev), gen, raster,
                               row[c * n_pad:c * n_pad + cp.hi - cp.lo], import_row,
                               _owner_starts(static, cp)))
    others = [[d for d in mesh.distinct if d != mesh.devices[c]] for c in range(k)]
    ctx = [device_context(d) for d in mesh.devices]  # the current card's: no switch
    for i in range(n_steps):
        t = state.t + i
        for c, core in enumerate(cores):
            with ctx[c]:
                core.phase_a(i, t)
        for c, core in enumerate(cores):  # the all-gather
            for d in others[c]:
                flat[d][c * n_pad:(c + 1) * n_pad].copy_(
                    flat[mesh.devices[c]][c * n_pad:(c + 1) * n_pad])
        for c, core in enumerate(cores):
            with ctx[c]:
                core.phase_b(t)
    final = _reassemble(plan, state, [c.final(home) for c in cores], state.t + n_steps, key)
    outputs = ({"spikes": torch.cat([c.raster.to(home) for c in cores], dim=1)}
               if want_raster else {})
    return final, outputs
