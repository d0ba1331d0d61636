"""Network builder: CARLsim's createGroup/connect API, compiled to tensors.

The builder mirrors how the paper's Synfire4 network is declared in CARLsim
(groups + connection groups, Tables I/II); ``compile()`` lowers it into

  * static: hashable topology (slices, delays, the bucket plan, dt, ...)
  * params: read-only tensors (neuron parameters, masks, CSR index
    tables, generator rates)
  * state: mutable tensors (membrane state, **fp16 synaptic weights**,
    delay ring, RNG key)

and registers every allocation against a :class:`MemoryLedger` under the
paper's seven load-step names, reproducing Tables III/IV byte for byte with
the reference. Connectivity comes from numpy ``default_rng(seed)`` with the
reference's calls, so a seed compiles to the same tables in both packages.

This slice compiles CUBA networks of IZH4/IZH9/LIF groups and Poisson
generators with ``packed``, ``sparse`` or ``auto`` propagation. Plasticity,
STP, conductances, in-run monitors, watches, core partitioning, the fused
tick and the ``loop`` oracle raise ``NotImplementedError`` naming the
ROADMAP item that brings them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import neurons as nrn
from repro_torch.core.synapses import (
    CSRFanin,
    ProjectionParams,
    ProjectionSpec,
    build_bernoulli,
    build_csr_direct,
    build_fixed_fanin,
    dense_to_csr,
)
from repro_torch.memory import MemoryLedger
from repro_torch.precision import PrecisionPolicy, get_policy

__all__ = ["NetworkBuilder", "CompiledNetwork", "NetStatic", "NetParams",
           "NetState", "BucketSpec", "GroupSpec"]


def _resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the card. Without one it raises: a run meant for the
    card never drifts onto the CPU; pass ``device="cpu"`` for that."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions")
        device = "cuda"
    return torch.device(device)


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP {item})")


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    name: str
    start: int
    size: int
    is_generator: bool = False
    rate_hz: float = 0.0  # rate during [0, until_ms), the stimulus pulse
    until_ms: float = math.inf
    rate_after_hz: float = 0.0  # sustained rate after the pulse


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """One propagation bucket; ``kind`` selects the execution strategy:

    * ``"dense"``: one block-dense ``[P, Q]`` matmul over the sorted union
      of its members' pre/post index ranges; ``members`` places each
      projection's weight block at ``(row, col)`` in the bucket image.
    * ``"sparse"``: a single-projection CSR fan-in bucket, weights stored
      as ``[Q, fanin]`` rows (``NetState.weights``), indices in
      ``NetParams.bucket_csr_idx``.

    ``pre_start >= 0`` marks a contiguous pre union starting there;
    ``post_start >= 0`` likewise for the post side."""

    delay_ms: int
    channel: int  # ring channel: 0 (CUBA has one signed channel)
    p: int
    q: int
    pre_start: int  # -1 => gather via params.bucket_pre_ids
    post_start: int  # -1 => scatter via params.bucket_post_ids
    members: tuple[tuple[int, int, int], ...]  # (proj_idx, row0, col0)
    kind: str = "dense"
    fanin: int = 0  # CSR row width (sparse buckets only)


@dataclasses.dataclass(frozen=True)
class NetStatic:
    """Hashable network topology.

    ``propagation``: ``"packed"`` lowers every projection to a dense
    bucket matmul; ``"sparse"`` to a CSR fan-in gather bucket with weights
    stored as ``[post, fanin]`` rows; ``"auto"`` picks per projection by
    the bytes-per-tick cost model (:func:`_csr_wins`). With exactly
    representable weights (the Synfire tables) all three give the same
    raster bit for bit.
    """

    n: int
    ring_len: int
    dt: float
    substeps: int
    method: str
    policy_name: str
    groups: tuple[GroupSpec, ...]
    projections: tuple[ProjectionSpec, ...]
    propagation: str = "packed"
    izh4_only: bool = False  # IZH4 + generators only: the kernel fast path
    buckets: tuple[BucketSpec, ...] = ()

    @property
    def gen_spans(self) -> tuple[tuple[int, int], ...]:
        """(start, size) of every generator group, the only neurons that
        consume per-tick uniforms."""
        return tuple((g.start, g.size) for g in self.groups if g.is_generator)

    @property
    def n_gen(self) -> int:
        return sum(size for _, size in self.gen_spans)

    @property
    def csr_projs(self) -> frozenset[int]:
        """Projection indices whose weights are stored CSR ``[post, fanin]``."""
        return frozenset(m[0] for b in self.buckets if b.kind == "sparse"
                         for m in b.members)


class NetParams(NamedTuple):
    neuron: nrn.NeuronParams
    # Per projection: [pre, post] bool for dense-stored projections, None
    # for CSR-stored ones (padding weights are exact zeros, so propagation
    # never needs a mask).
    masks: tuple[torch.Tensor | None, ...]
    gen_rate: torch.Tensor  # [N] Hz during the pulse (0 for non-generators)
    gen_until: torch.Tensor  # [N] ms pulse end
    gen_rate_after: torch.Tensor  # [N] Hz sustained after the pulse
    # Aligned with static.buckets: int32 pre/post id lists of dense buckets
    # (empty for sparse ones), and the CSR fan-in index tables of sparse
    # buckets ([Q, fanin] int16/int32, local to the pre slice; None for
    # dense ones).
    bucket_pre_ids: tuple[torch.Tensor, ...] = ()
    bucket_post_ids: tuple[torch.Tensor, ...] = ()
    bucket_csr_idx: tuple[torch.Tensor | None, ...] = ()


class NetState(NamedTuple):
    t: int  # tick, a Python int: the tick loop never reads the device for it
    key: torch.Tensor  # int64 scalar, seeds run()'s generator stream
    neurons: nrn.NeuronState
    ring: torch.Tensor  # [D, N, 1] storage dtype
    weights: tuple[torch.Tensor, ...]  # per projection, storage dtype


@dataclasses.dataclass
class _PendingConnect:
    pre: str
    post: str
    fanin: int
    weight: float
    delay_ms: int
    mode: str = "fanin"  # "fanin" (exact) | "prob" (CARLsim random connect)


def _to_device(tree, device: torch.device):
    """Move every tensor of a nested NamedTuple/tuple tree to ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(x, device) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_to_device(x, device) for x in tree)
    return tree


class NetworkBuilder:
    """CARLsim-style declarative network construction."""

    def __init__(self, *, seed: int = 42):
        self._groups: list[tuple[str, nrn.NeuronParams, GroupSpec]] = []
        self._connects: list[_PendingConnect] = []
        self._cursor = 0
        self._seed = seed

    def add_group(self, name: str, params: nrn.NeuronParams) -> str:
        size = int(params.model.shape[0])
        spec = GroupSpec(name=name, start=self._cursor, size=size)
        self._groups.append((name, params, spec))
        self._cursor += size
        return name

    def add_spike_generator(self, name: str, size: int, rate_hz: float,
                            until_ms: float = math.inf,
                            rate_after_hz: float = 0.0) -> str:
        spec = GroupSpec(name=name, start=self._cursor, size=size,
                         is_generator=True, rate_hz=rate_hz,
                         until_ms=until_ms, rate_after_hz=rate_after_hz)
        self._groups.append((name, nrn.generator(size), spec))
        self._cursor += size
        return name

    def connect(self, pre: str, post: str, *, fanin: int, weight: float,
                delay_ms: int, plastic: bool = False, stdp=None, stp=None,
                da_modulated: bool = False, mode: str = "fanin",
                homeostasis=None) -> None:
        if plastic or stdp is not None or da_modulated:
            raise _unported("plastic projections (STDP, DA-STDP)", "A7")
        if stp is not None:
            raise _unported("short-term plasticity", "A7")
        if homeostasis is not None:
            raise _unported("homeostasis", "A7")
        if delay_ms < 1:
            raise ValueError("delay must be >= 1 ms (one tick)")
        self._connects.append(
            _PendingConnect(pre, post, fanin, weight, delay_ms, mode))

    def compile(
        self,
        *,
        policy: str | PrecisionPolicy = "fp32",
        dt: float = 1.0,
        substeps: int = 2,
        method: str = "euler",
        conductances=None,
        ledger: MemoryLedger | None = None,
        monitor_ms_hint: int = 0,
        monitors=None,
        watches=None,
        backend: str | None = None,
        propagation: str = "packed",
        pack_density: float = 0.5,
        homeostasis_period: int = 0,
        partition=None,
        device: str | torch.device | None = None,
    ) -> "CompiledNetwork":
        """Lower the declared network to tensors on ``device`` (the card
        when ``None``). ``backend`` takes no value but ``None``: the port
        dispatches by device, kernels for CUDA tensors and their plain
        versions for CPU tensors."""
        if backend == "fused":
            raise _unported("backend='fused' (the one-program tick)", "A8/B4")
        if backend is not None:
            raise ValueError(
                f"unknown backend {backend!r}: repro_torch dispatches by "
                "device (CUDA kernels on the card, plain PyTorch on the CPU)")
        if propagation == "loop":
            raise _unported("propagation='loop' (the per-projection oracle)", "A5")
        if propagation not in ("packed", "sparse", "auto"):
            raise ValueError(f"unknown propagation {propagation!r}")
        if conductances is not None:
            raise _unported("conductance-based synapses (COBA)", "A7")
        if monitors is not None:
            raise _unported("in-run monitors", "A6")
        if watches is not None:
            raise _unported("watchpoints", "A10")
        if homeostasis_period:
            raise _unported("homeostasis", "A7")
        if partition is not None:
            raise _unported("core partitioning", "A11")
        device = _resolve_device(device)
        if isinstance(policy, str):
            policy = get_policy(policy)
        ledger = ledger if ledger is not None else MemoryLedger()
        sdt = policy.state_storage
        wdt = policy.param_storage

        groups = tuple(spec for _, _, spec in self._groups)
        n = self._cursor

        # 1. CARLsim Init: builder bookkeeping / static tables (counted,
        # never used by the port, so never allocated).
        with ledger.stage("1. CARLsim Init."):
            ledger.register("static.tables", torch.empty(
                (len(groups) * 16,), dtype=torch.int32, device="meta"))

        # 2. Random Gen: RNG key (8 bytes, as the reference's threefry key)
        # + generator schedules.
        key = torch.tensor(self._seed, dtype=torch.int64)
        gen_rate = np.zeros((n,), np.float32)
        gen_until = np.full((n,), np.float32(np.inf))
        gen_rate_after = np.zeros((n,), np.float32)
        for spec in groups:
            if spec.is_generator:
                sl = slice(spec.start, spec.start + spec.size)
                gen_rate[sl] = spec.rate_hz
                gen_until[sl] = spec.until_ms
                gen_rate_after[sl] = spec.rate_after_hz
        gen_rate, gen_until, gen_rate_after = (
            torch.from_numpy(x) for x in (gen_rate, gen_until, gen_rate_after))
        with ledger.stage("2. Random Gen."):
            ledger.register("rng", (key, gen_rate, gen_until, gen_rate_after))

        # 3. Conn. Info: connectivity (host-side build), realized fan-in,
        # and the propagation plan, computed before registration so
        # sparse-assigned projections register CSR index tables instead of
        # dense bool masks.
        rng = np.random.default_rng(self._seed)
        specs: list[ProjectionSpec] = []
        projs: list[ProjectionParams | CSRFanin] = []
        for c in self._connects:
            gpre = next(s for s in groups if s.name == c.pre)
            gpost = next(s for s in groups if s.name == c.post)
            spec = ProjectionSpec(
                name=f"{c.pre}->{c.post}",
                pre_start=gpre.start, pre_size=gpre.size,
                post_start=gpost.start, post_size=gpost.size,
                delay_ms=int(round(c.delay_ms / dt)),
                receptor="inh" if c.weight < 0 else "exc",
            )
            specs.append(spec)
            if gpre.size * gpost.size > _DENSE_BUILD_CELLS:
                # Too big for a dense host-side mask: sample the fan-in rows
                # directly (different draws; the threshold keeps every
                # baseline network on the dense builders).
                projs.append(build_csr_direct(
                    rng, spec, c.fanin, c.weight,
                    mode=("fanin" if c.mode == "fanin" else "prob"),
                    storage_dtype=wdt))
            else:
                builder = build_fixed_fanin if c.mode == "fanin" else build_bernoulli
                projs.append(builder(rng, spec, c.fanin, c.weight,
                                     storage_dtype=wdt))
        for j, p in enumerate(projs):
            if isinstance(p, CSRFanin):
                fanin, n_syn = int(p.valid.shape[1]), int(p.valid.sum())
            else:
                m = p.mask.numpy()
                fanin, n_syn = int(m.sum(axis=0).max(initial=0)), int(m.sum())
            specs[j] = dataclasses.replace(specs[j], fanin=fanin, n_syn=n_syn)
        buckets, pre_ids, post_ids = _plan_buckets(
            tuple(specs), pack_density, propagation)
        csr_set = frozenset(m[0] for b in buckets if b.kind == "sparse"
                            for m in b.members)
        for j, p in enumerate(projs):
            if isinstance(p, CSRFanin) and j not in csr_set:
                raise ValueError(
                    f"{specs[j].name}: {specs[j].pre_size}×{specs[j].post_size} "
                    "is past the dense build threshold and was sampled straight "
                    f"into CSR rows, but propagation={propagation!r} assigned it "
                    "dense storage: compile with propagation='sparse' or 'auto'")
        csr: dict[int, CSRFanin] = {
            j: (projs[j] if isinstance(projs[j], CSRFanin)
                else dense_to_csr(projs[j].mask, projs[j].weight,
                                  fanin=specs[j].fanin, storage_dtype=wdt))
            for j in sorted(csr_set)
        }
        bucket_csr_idx = tuple(
            csr[b.members[0][0]].idx if b.kind == "sparse" else None
            for b in buckets)
        masks = tuple(None if j in csr_set else p.mask
                      for j, p in enumerate(projs))
        weights = tuple(csr[j].weight if j in csr_set else p.weight
                        for j, p in enumerate(projs))
        with ledger.stage("3. Conn. Info"):
            ledger.register("masks", tuple(m for m in masks if m is not None))
            if csr:
                ledger.register("csr.indices", tuple(c.idx for c in csr.values()))

        # 4. Syn. State: weights (the fp16 payload; CSR rows for sparse
        # projections) and the delay ring.
        ring_len = max((s.delay_ms for s in specs), default=1) + 1
        ring = torch.zeros((ring_len, n, 1), dtype=sdt)
        with ledger.stage("4. Syn. State"):
            ledger.register("weights", weights)
            ledger.register("ring", ring)
            ledger.register("stp", ())

        # 5. Neuron State and 6. Group State.
        neuron_params = nrn.concat_params([p for _, p, _ in self._groups])
        nstate = nrn.init_neuron_state(neuron_params, sdt)
        with ledger.stage("5. Neuron State"):
            ledger.register("neuron.state", nstate)
        with ledger.stage("6. Group State"):
            ledger.register("neuron.params", neuron_params)

        # 7. Auxiliary Data: plasticity traces (none in this slice) and the
        # raster buffer a monitor window of `monitor_ms_hint` ticks needs.
        with ledger.stage("7. Auxiliary Data"):
            ledger.register("stdp.traces", ())
            if monitor_ms_hint:
                ledger.register("monitor.spikes", torch.empty(
                    (monitor_ms_hint, n), dtype=torch.bool, device="meta"))

        codes = neuron_params.model.numpy()
        izh4_only = bool(np.all((codes == int(nrn.NeuronModel.GENERATOR))
                                | (codes == int(nrn.NeuronModel.IZH4))))
        static = NetStatic(
            n=n, ring_len=ring_len, dt=dt, substeps=substeps, method=method,
            policy_name=policy.name, groups=groups, projections=tuple(specs),
            propagation=propagation, izh4_only=izh4_only, buckets=buckets,
        )
        params = NetParams(
            neuron=neuron_params, masks=masks, gen_rate=gen_rate,
            gen_until=gen_until, gen_rate_after=gen_rate_after,
            bucket_pre_ids=pre_ids, bucket_post_ids=post_ids,
            bucket_csr_idx=bucket_csr_idx,
        )
        state0 = NetState(t=0, key=key, neurons=nstate, ring=ring,
                          weights=weights)
        return CompiledNetwork(static=static,
                               params=_to_device(params, device),
                               state0=_to_device(state0, device),
                               ledger=ledger, policy=policy)


# How many × fewer bytes the CSR layout must touch per tick before a
# projection is auto-assigned the sparse gather: dense reads 4·pre·post
# bytes (the hoisted f32 image), CSR reads ≤ 8·post·fanin (index + hoisted
# f32 weight).
_SPARSE_ADVANTAGE = 4.0

# Above this many pre×post cells a projection skips the dense host-side
# mask build and samples CSR fan-in rows directly (`build_csr_direct`).
_DENSE_BUILD_CELLS = 1 << 25


def _csr_wins(spec: ProjectionSpec) -> bool:
    """Cost model: bytes touched per tick, dense image vs CSR fan-in rows."""
    dense_bytes = 4 * spec.pre_size * spec.post_size
    csr_bytes = 8 * spec.post_size * max(spec.fanin, 1)
    return dense_bytes >= _SPARSE_ADVANTAGE * csr_bytes


def _plan_buckets(
    specs: tuple[ProjectionSpec, ...], pack_density: float,
    propagation: str = "packed",
) -> tuple[tuple[BucketSpec, ...], tuple[torch.Tensor, ...],
           tuple[torch.Tensor, ...]]:
    """Compile-time propagation plan.

    Each projection goes sparse (one ``kind="sparse"`` bucket) when forced
    by ``"sparse"`` or picked by ``"auto"``'s cost model; the rest are
    grouped by delay and each group lowers to ONE block-dense matmul over
    the sorted union of its pre/post ranges when the member blocks fill at
    least ``pack_density`` of the union rectangle. Otherwise projections
    sharing a pre range merge when they fill it densely enough, and the
    rest get a bucket each.
    """
    grouped: dict[tuple[int, int], list[int]] = {}
    sparse_js: list[int] = []
    for j, s in enumerate(specs):
        if propagation == "sparse" or (propagation == "auto" and _csr_wins(s)):
            sparse_js.append(j)
        else:
            grouped.setdefault((s.delay_ms, 0), []).append(j)

    buckets: list[BucketSpec] = []
    pre_ids: list[torch.Tensor] = []
    post_ids: list[torch.Tensor] = []
    empty = torch.zeros((0,), dtype=torch.int32)

    for j in sparse_js:
        s = specs[j]
        buckets.append(BucketSpec(
            delay_ms=s.delay_ms, channel=0, p=s.pre_size, q=s.post_size,
            pre_start=s.pre_start, post_start=s.post_start,
            members=((j, 0, 0),), kind="sparse", fanin=s.fanin,
        ))
        # Single-projection spans are contiguous: the id lists stay empty.
        pre_ids.append(empty)
        post_ids.append(empty)

    def unions(members: list[int]) -> tuple[np.ndarray, np.ndarray]:
        pres = np.unique(np.concatenate([
            np.arange(specs[j].pre_start, specs[j].pre_start + specs[j].pre_size)
            for j in members]))
        posts = np.unique(np.concatenate([
            np.arange(specs[j].post_start, specs[j].post_start + specs[j].post_size)
            for j in members]))
        return pres, posts

    def emit(delay_ms: int, channel: int, members: list[int]) -> None:
        pres, posts = unions(members)
        placed = tuple(
            (j, int(np.searchsorted(pres, specs[j].pre_start)),
             int(np.searchsorted(posts, specs[j].post_start)))
            for j in members)
        p, q = int(pres.size), int(posts.size)
        pre_contig = int(pres[-1]) - int(pres[0]) + 1 == p
        post_contig = int(posts[-1]) - int(posts[0]) + 1 == q
        buckets.append(BucketSpec(
            delay_ms=delay_ms, channel=channel, p=p, q=q,
            pre_start=int(pres[0]) if pre_contig else -1,
            post_start=int(posts[0]) if post_contig else -1,
            members=placed,
        ))
        pre_ids.append(torch.from_numpy(pres.astype(np.int32)))
        post_ids.append(torch.from_numpy(posts.astype(np.int32)))

    def fill(members: list[int]) -> float:
        pres, posts = unions(members)
        cells = sum(specs[j].pre_size * specs[j].post_size for j in members)
        return cells / float(pres.size * posts.size)

    for (delay_ms, channel), members in grouped.items():
        if len(members) > 1 and fill(members) >= pack_density:
            emit(delay_ms, channel, members)
            continue
        by_pre: dict[tuple[int, int], list[int]] = {}
        for j in members:
            by_pre.setdefault((specs[j].pre_start, specs[j].pre_size), []).append(j)
        for sub in by_pre.values():
            if len(sub) > 1 and fill(sub) >= pack_density:
                emit(delay_ms, channel, sub)
            else:
                for j in sub:
                    emit(delay_ms, channel, [j])
    return tuple(buckets), tuple(pre_ids), tuple(post_ids)


@dataclasses.dataclass
class CompiledNetwork:
    static: NetStatic
    params: NetParams
    state0: NetState
    ledger: MemoryLedger
    policy: PrecisionPolicy

    @property
    def n_neurons(self) -> int:
        return self.static.n

    @property
    def n_synapses(self) -> int:
        return int(sum(s.n_syn for s in self.static.projections))
