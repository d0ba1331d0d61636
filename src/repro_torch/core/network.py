"""Network builder: CARLsim's createGroup/connect API, compiled to tensors.

The builder mirrors how the paper's Synfire4 network is declared in CARLsim
(groups + connection groups, Tables I/II); ``compile()`` lowers it into

  * static: hashable topology (slices, delays, the bucket plan, dt, ...)
  * params: read-only tensors (neuron parameters, masks, CSR index
    tables, generator rates)
  * state: mutable tensors (membrane state, **fp16 synaptic weights**,
    delay ring, RNG key, STP/STDP traces, homeostasis rates)

and registers every allocation against a :class:`MemoryLedger` under the
paper's seven load-step names, reproducing Tables III/IV byte for byte with
the reference. Connectivity comes from numpy ``default_rng(seed)`` with the
reference's calls, so a seed compiles to the same tables in both packages.

The port compiles networks of IZH4/IZH9/LIF groups and Poisson
generators, current-based (CUBA: one signed ring channel) or
conductance-based (``conductances=COBAConfig()``: two ring channels, the
excitatory and inhibitory magnitudes), with ``packed``, ``sparse`` or
``auto`` propagation, on the default backend or ``backend="fused"`` (one
program per tick), or with the ``loop`` oracle (every projection
dense-stored and propagated on its own), with plastic (STDP, DA-STDP,
homeostasis) and STP projections, in-run monitors
(``monitors="default"``: SpikeCount and GroupRate, as the reference's
default) and in-run watches (``watches="default"``: NonFinite, RateBand
and Silent, :mod:`repro_torch.obs.watch`), and cut into fixed-budget
cores (``partition=PartitionSpec(...)``, :mod:`repro_torch.core.partition`:
the plan lands in ``CompiledNetwork.partition``, which ``Engine.run``
follows).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import neurons as nrn
from repro_torch.core import rng as threefry
from repro_torch.core.conductance import (
    COBAConfig,
    ConductanceState,
    init_conductance_state,
)
from repro_torch.core.plasticity import (
    DASTDPState,
    HomeostasisConfig,
    STDPConfig,
    STDPState,
    init_da_stdp_state,
    init_stdp_state,
)
from repro_torch.core.synapses import (
    CSRFanin,
    ProjectionParams,
    ProjectionSpec,
    STPConfig,
    STPState,
    build_bernoulli,
    build_csr_direct,
    build_fixed_fanin,
    csr_layout,
    dense_to_csr,
    init_stp_state,
)
from repro_torch.memory import MemoryLedger
from repro_torch.obs import watch as wspec
from repro_torch.precision import PrecisionPolicy, get_policy
from repro_torch.telemetry import monitors as telem

__all__ = ["NetworkBuilder", "CompiledNetwork", "NetStatic", "NetParams",
           "NetState", "BucketSpec", "FusedPlan", "GroupSpec", "ring_channel"]


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
    channel: int  # ring channel: 0 = exc or signed (CUBA), 1 = inh magnitude (COBA)
    p: int
    q: int
    pre_start: int  # -1 => gather via params.bucket_pre_ids
    post_start: int  # -1 => scatter via params.bucket_post_ids
    members: tuple[tuple[int, int, int], ...]  # (proj_idx, row0, col0)
    kind: str = "dense"
    fanin: int = 0  # CSR row width (sparse buckets only)


@dataclasses.dataclass(frozen=True)
class FusedPlan:
    """Compile-time plan of ``backend="fused"`` (one program per tick).

    The bucket plan is reused: ``dense_classes`` groups the dense buckets
    by ``[P, Q]`` shape as the reference's plan does (the reference batches
    each class; the port adds the buckets one by one in plan order and
    reads no class), CSR buckets (``sparse_ids``) gather their fan-in rows,
    and the distinct ``delays`` (those of the buckets and of the plastic
    and STP projections) are the ring commits of the tick's epilogue.
    ``kernel_ok`` marks a net whose whole tick is the ``fused_tick``
    kernel: IZH4 and generators only, Euler, contiguous bucket spans, no
    plastic or STP projection (the kernel knows nothing of learning), and
    one ring channel (CUBA: the kernel knows no conductances). The
    reference's ``tile_q``/``tile_r`` size TPU VMEM buffers and have no
    counterpart here."""

    delays: tuple[int, ...]  # sorted distinct ring delays committed per tick
    # ((p, q), bucket_ids): dense buckets sharing a [P, Q] shape.
    dense_classes: tuple[tuple[tuple[int, int], tuple[int, ...]], ...]
    sparse_ids: tuple[int, ...]  # bucket indices executed as CSR gathers
    kernel_ok: bool


def _plan_fused(buckets: tuple[BucketSpec, ...], specs: tuple[ProjectionSpec, ...],
                channels: int, izh4_only: bool, method: str) -> FusedPlan:
    per_proj = [s for s in specs if s.plastic or s.stp is not None]
    classes: dict[tuple[int, int], list[int]] = {}
    sparse_ids: list[int] = []
    for bi, b in enumerate(buckets):
        if b.kind == "sparse":
            sparse_ids.append(bi)
        else:
            classes.setdefault((b.p, b.q), []).append(bi)
    spans_ok = all(b.pre_start >= 0 and b.post_start >= 0 for b in buckets)
    return FusedPlan(
        delays=tuple(sorted({b.delay_ms for b in buckets}
                            | {s.delay_ms for s in per_proj})),
        dense_classes=tuple((pq, tuple(ids)) for pq, ids in classes.items()),
        sparse_ids=tuple(sparse_ids),
        kernel_ok=(channels == 1 and izh4_only and method == "euler" and spans_ok
                   and not per_proj),
    )


@dataclasses.dataclass(frozen=True)
class NetStatic:
    """Hashable network topology.

    ``propagation``: ``"packed"`` lowers every non-plastic, non-STP
    projection to a dense bucket matmul; ``"sparse"`` to a CSR fan-in
    gather bucket with weights stored as ``[post, fanin]`` rows; ``"auto"``
    picks per projection by the bytes-per-tick cost model
    (:func:`_csr_wins`); ``"loop"`` is the oracle: every projection
    dense-stored and propagated on its own, one ring commit each. With
    exactly representable weights (the Synfire tables) all four give the
    same raster bit for bit.

    Plastic and STP projections join no bucket: their weights change every
    tick. Their drive and their weight updates run on fan-in rows over
    ``NetParams.proj_csr_idx`` in every mode but ``"loop"``, so plastic runs stay bit
    for bit across modes as STDP moves weights off the representable grid.
    Plastic non-STP projections are stored as CSR rows (``plastic_csr``)
    under ``"sparse"``, and under ``"auto"`` where the plastic cost model
    picks it; STP projections always but under ``"loop"`` (``stp_csr``).

    ``ring_channels`` is 1 for CUBA (a signed current) and 2 for COBA
    (``coba`` set: excitatory and inhibitory magnitudes).
    """

    n: int
    ring_len: int
    ring_channels: int
    dt: float
    substeps: int
    method: str
    policy_name: str
    groups: tuple[GroupSpec, ...]
    projections: tuple[ProjectionSpec, ...]
    stdp: tuple[STDPConfig | None, ...] = ()  # aligned with projections
    coba: COBAConfig | None = None
    propagation: str = "packed"
    izh4_only: bool = False  # IZH4 + generators only: the kernel fast path
    buckets: tuple[BucketSpec, ...] = ()
    backend: str | None = None  # None (per-phase kernels) | "fused"
    fused: FusedPlan | None = None  # backend="fused" only
    plastic_csr: tuple[int, ...] = ()  # plastic non-STP projections stored CSR
    stp_csr: tuple[int, ...] = ()  # STP projections (always stored CSR)
    # Slow-timer homeostasis, aligned with projections (None: none); the
    # engine applies it every ``homeo_period`` ticks between segments.
    homeo: tuple[HomeostasisConfig | None, ...] = ()
    homeo_period: int = 0
    # In-run monitor specs (repro_torch.telemetry); the engine keeps their
    # accumulators when run(record="monitors"/"both").
    monitors: tuple = ()
    # In-run watch specs (repro_torch.obs.watch); every run of the net keeps
    # their accumulators and returns them as outputs["watch_carry"].
    watches: tuple = ()

    @property
    def fused_kernel(self) -> bool:
        """The whole tick is the fused_tick kernel (on CPU tensors its
        plain version): the fused plan's ``kernel_ok``."""
        return self.fused is not None and self.fused.kernel_ok

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
        """Projection indices whose weights are stored CSR ``[post, fanin]``:
        sparse-bucket members, ``plastic_csr`` and ``stp_csr``."""
        return (frozenset(m[0] for b in self.buckets if b.kind == "sparse"
                          for m in b.members)
                | frozenset(self.plastic_csr) | frozenset(self.stp_csr))


class NetParams(NamedTuple):
    neuron: nrn.NeuronParams
    # Per projection: [pre, post] bool for dense-stored projections, the
    # [post, fanin] bool validity rows (the STDP mask) for plastic CSR-stored
    # ones, None for other CSR-stored ones (padding weights are exact zeros,
    # so propagation never needs a mask).
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
    # Per-projection fan-in index tables [post, fanin] (int16/int32, local
    # to the pre group), aligned with static.projections: the CSR idx of
    # every CSR-stored projection, and for dense-stored plastic ones a
    # table whose padding is the sentinel n_pre (one past the pre group,
    # where the drive gathers an appended zero) instead of 0; None else.
    proj_csr_idx: tuple[torch.Tensor | None, ...] = ()


class NetState(NamedTuple):
    t: int  # tick, a Python int: the tick loop never reads the device for it
    key: torch.Tensor  # int32 [2]: the reference's threefry key words (core.rng)
    neurons: nrn.NeuronState
    ring: torch.Tensor  # [D, N, C] storage dtype, C = static.ring_channels
    weights: tuple[torch.Tensor, ...]  # per projection, storage dtype
    stp: tuple[STPState | None, ...] = ()  # per projection
    stdp: tuple[STDPState | DASTDPState | None, ...] = ()  # per projection
    cond: ConductanceState | None = None  # COBA nets only
    # Per projection: homeostasis running-average rate [post] f32 (None
    # where static.homeo[j] is None).
    homeo: tuple[torch.Tensor | None, ...] = ()


@dataclasses.dataclass
class _PendingConnect:
    pre: str
    post: str
    fanin: int
    weight: float
    delay_ms: int
    plastic: bool
    stdp: STDPConfig | None
    stp: STPConfig | None
    da_modulated: bool
    mode: str = "fanin"  # "fanin" (exact) | "prob" (CARLsim random connect)
    homeostasis: HomeostasisConfig | None = None


def _to_device(tree, device: torch.device, _moved=None):
    """Move every tensor of a nested NamedTuple/tuple tree to ``device``.
    A tensor that appears twice (a CSR index table that is both a bucket's
    and its projection's) is moved once and stays one tensor."""
    moved = {} if _moved is None else _moved
    if isinstance(tree, torch.Tensor):
        if id(tree) not in moved:
            moved[id(tree)] = (tree, tree.to(device))
        return moved[id(tree)][1]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(x, device, moved) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_to_device(x, device, moved) for x in tree)
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
                delay_ms: int, plastic: bool = False,
                stdp: STDPConfig | None = None, stp: STPConfig | None = None,
                da_modulated: bool = False, mode: str = "fanin",
                homeostasis: HomeostasisConfig | None = None) -> None:
        """Connect ``pre`` to ``post``. A projection with ``stdp`` or
        ``homeostasis`` is plastic; ``da_modulated`` makes its STDP
        dopamine-gated (``tau_elig`` defaults to 100 ms); ``stp`` adds
        short-term plasticity."""
        if delay_ms < 1:
            raise ValueError("delay must be >= 1 ms (one tick)")
        if homeostasis is not None and stp is not None:
            raise ValueError("homeostasis on STP projections is unsupported")
        self._connects.append(_PendingConnect(
            pre, post, fanin, weight, delay_ms,
            plastic or stdp is not None or homeostasis is not None,
            stdp, stp, da_modulated, mode, homeostasis))

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
        monitors="default",
        watches=None,
        backend: str | None = None,
        propagation: str = "packed",
        pack_density: float = 0.5,
        homeostasis_period: int = 0,
        partition=None,
        device: str | torch.device | None = None,
    ) -> "CompiledNetwork":
        """Lower the declared network to tensors on ``device`` (the card
        when ``None``). ``backend`` is ``None`` (a kernel per tick phase)
        or ``"fused"`` (the whole tick as one ``fused_tick`` launch where
        the plan allows it). Either way the port dispatches by device:
        kernels for CUDA tensors, their plain versions for CPU tensors."""
        if backend not in (None, "fused"):
            raise ValueError(
                f"unknown backend {backend!r}: repro_torch takes None or "
                "'fused', and dispatches by device (CUDA kernels on the "
                "card, plain PyTorch on the CPU)")
        if backend == "fused" and propagation == "loop":
            raise ValueError(
                "backend='fused' fuses the bucketed tick; it has no "
                "per-projection loop expression: use propagation="
                "'packed'/'sparse'/'auto'")
        if propagation not in ("packed", "sparse", "auto", "loop"):
            raise ValueError(f"unknown propagation {propagation!r}")
        if any(c.homeostasis is not None for c in self._connects):
            if homeostasis_period < 1:
                raise ValueError(
                    "connections carry homeostasis configs but "
                    f"homeostasis_period is {homeostasis_period}: pass the "
                    "slow-timer period (in ticks) to compile()")
        elif homeostasis_period:
            raise ValueError("homeostasis_period set but no connection has a "
                             "HomeostasisConfig")
        if partition is not None and watches is not None and watches != ():
            raise ValueError(
                "watches are not supported on partitioned networks yet — "
                "the per-core lowerings carry no watch accumulators")
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

        # 2. Random Gen: RNG key (8 bytes, the reference's threefry key)
        # + generator schedules.
        key = threefry.key(self._seed)
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
        stdp_cfgs: list[STDPConfig | None] = []
        homeo_cfgs: list[HomeostasisConfig | None] = []
        for c in self._connects:
            gpre = next(s for s in groups if s.name == c.pre)
            gpost = next(s for s in groups if s.name == c.post)
            spec = ProjectionSpec(
                name=f"{c.pre}->{c.post}",
                pre_start=gpre.start, pre_size=gpre.size,
                post_start=gpost.start, post_size=gpost.size,
                delay_ms=int(round(c.delay_ms / dt)),
                receptor="inh" if c.weight < 0 else "exc",
                plastic=c.plastic, stp=c.stp,
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
            cfg = c.stdp
            if cfg is not None and c.da_modulated and cfg.tau_elig is None:
                cfg = dataclasses.replace(cfg, tau_elig=100.0)
            stdp_cfgs.append(cfg)
            homeo_cfgs.append(c.homeostasis)
        for j, p in enumerate(projs):
            if isinstance(p, CSRFanin):
                fanin, n_syn = int(p.valid.shape[1]), int(p.valid.sum())
            else:
                m = p.mask.numpy()
                fanin, n_syn = int(m.sum(axis=0).max(initial=0)), int(m.sum())
            specs[j] = dataclasses.replace(specs[j], fanin=fanin, n_syn=n_syn)
        channels = 2 if conductances is not None else 1
        buckets, pre_ids, post_ids = _plan_buckets(
            tuple(specs), channels, pack_density, propagation)
        # Plastic non-STP projections join no bucket, but their storage
        # flips to CSR fan-in rows when forced ("sparse") or when the
        # plastic cost model wins ("auto"); STP projections are CSR-stored
        # in every mode but the loop oracle's (the per-pre u·x scale
        # composes with the gather).
        plastic_csr = tuple(
            j for j, s in enumerate(specs)
            if s.plastic and s.stp is None
            and (propagation == "sparse"
                 or (propagation == "auto" and _csr_wins(s))))
        stp_csr = tuple(j for j, s in enumerate(specs)
                        if s.stp is not None and propagation != "loop")
        csr_set = (frozenset(m[0] for b in buckets if b.kind == "sparse"
                             for m in b.members)
                   | frozenset(plastic_csr) | frozenset(stp_csr))
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
        # Per-projection fan-in tables: CSR-stored projections alias their
        # CSR idx; dense-stored plastic ones get a sentinel-padded table, so
        # the drive and the updates run the same row arithmetic on the dense
        # rectangle (what keeps plastic runs bit for bit across modes); the
        # loop oracle's plastic projections propagate their dense rectangle
        # and need none.
        proj_csr_idx: list[torch.Tensor | None] = []
        for j, s in enumerate(specs):
            if j in csr_set:
                proj_csr_idx.append(csr[j].idx)
            elif s.plastic and s.stp is None and propagation != "loop":
                idx, valid = csr_layout(projs[j].mask.numpy(), fanin=s.fanin)
                sent = np.where(valid, idx, s.pre_size)
                idt = np.int16 if s.pre_size <= np.iinfo(np.int16).max else np.int32
                proj_csr_idx.append(torch.from_numpy(np.ascontiguousarray(
                    sent.astype(idt))))
            else:
                proj_csr_idx.append(None)
        masks = tuple(
            (torch.from_numpy(csr[j].valid) if s.plastic else None) if j in csr_set
            else p.mask for j, (s, p) in enumerate(zip(specs, projs)))
        weights = tuple(csr[j].weight if j in csr_set else p.weight
                        for j, p in enumerate(projs))
        with ledger.stage("3. Conn. Info"):
            ledger.register("masks", tuple(m for m in masks if m is not None))
            idx_tables = tuple(t for t in proj_csr_idx if t is not None)
            if idx_tables:
                ledger.register("csr.indices", idx_tables)

        # 4. Syn. State: weights (the fp16 payload; CSR rows for CSR-stored
        # projections), the delay ring, STP state.
        ring_len = max((s.delay_ms for s in specs), default=1) + 1
        ring = torch.zeros((ring_len, n, channels), dtype=sdt)
        stp_states = tuple(init_stp_state(s.stp, s.pre_size, sdt)
                           if s.stp is not None else None for s in specs)
        with ledger.stage("4. Syn. State"):
            ledger.register("weights", weights)
            ledger.register("ring", ring)
            ledger.register("stp", tuple(s for s in stp_states if s is not None))

        # 5. Neuron State (v, u, refractory, conductances) and 6. Group
        # State.
        neuron_params = nrn.concat_params([p for _, p, _ in self._groups])
        nstate = nrn.init_neuron_state(neuron_params, sdt)
        cond = init_conductance_state(n, sdt) if conductances is not None else None
        with ledger.stage("5. Neuron State"):
            ledger.register("neuron.state", nstate)
            if cond is not None:
                ledger.register("conductances", cond)
        with ledger.stage("6. Group State"):
            ledger.register("neuron.params", neuron_params)

        # 7. Auxiliary Data: plasticity traces (DA eligibility on the fan-in
        # rows of CSR-stored projections), homeostasis rates, the raster
        # buffer a monitor window of `monitor_ms_hint` ticks needs, and the
        # in-run monitors' storage over that window (1,000 ticks without
        # one): O(N + probes·T), never the O(T·N) raster.
        stdp_states = tuple(
            None if cfg is None
            else init_da_stdp_state(s.pre_size, s.post_size, sdt,
                                    fanin=s.fanin if j in csr_set else None)
            if cfg.tau_elig is not None
            else init_stdp_state(s.pre_size, s.post_size)
            for j, (s, cfg) in enumerate(zip(specs, stdp_cfgs)))
        homeo_states = tuple(
            None if h is None else torch.zeros((s.post_size,), dtype=torch.float32)
            for s, h in zip(specs, homeo_cfgs))
        mon_specs = telem.resolve(monitors, n=n, n_projections=len(specs), dt=dt)
        # Watch baselines (WeightDrift) come from the state0 weights, through
        # the L2 expression telemetry.WeightNorm reports.
        watch_specs = wspec.resolve(
            watches, n=n, n_projections=len(specs), dt=dt,
            baseline_norms=tuple(telem.weight_norms(weights).tolist())
            if watches is not None and weights else None)
        with ledger.stage("7. Auxiliary Data"):
            ledger.register("stdp.traces", tuple(s for s in stdp_states if s is not None))
            if any(h is not None for h in homeo_states):
                ledger.register("homeo.avg_rate",
                                tuple(h for h in homeo_states if h is not None))
            if monitor_ms_hint:
                ledger.register("monitor.spikes", torch.empty(
                    (monitor_ms_hint, n), dtype=torch.bool, device="meta"))
            if mon_specs:
                ledger.register("monitor.telemetry", telem.carry_struct(
                    mon_specs, n, len(specs), monitor_ms_hint or 1000))
            if watch_specs:
                ledger.register("monitor.watch",
                                wspec.carry_struct(watch_specs, n, len(specs)))

        codes = neuron_params.model.numpy()
        izh4_only = bool(np.all((codes == int(nrn.NeuronModel.GENERATOR))
                                | (codes == int(nrn.NeuronModel.IZH4))))
        fused = (_plan_fused(buckets, tuple(specs), channels, izh4_only, method)
                 if backend == "fused" else None)
        static = NetStatic(
            n=n, ring_len=ring_len, ring_channels=channels, dt=dt, substeps=substeps,
            method=method, policy_name=policy.name, groups=groups,
            projections=tuple(specs), stdp=tuple(stdp_cfgs), coba=conductances,
            propagation=propagation, izh4_only=izh4_only,
            buckets=buckets, backend=backend, fused=fused, plastic_csr=plastic_csr,
            stp_csr=stp_csr, homeo=tuple(homeo_cfgs),
            homeo_period=int(homeostasis_period), monitors=mon_specs,
            watches=watch_specs,
        )
        params = NetParams(
            neuron=neuron_params, masks=masks, gen_rate=gen_rate,
            gen_until=gen_until, gen_rate_after=gen_rate_after,
            bucket_pre_ids=pre_ids, bucket_post_ids=post_ids,
            bucket_csr_idx=bucket_csr_idx, proj_csr_idx=tuple(proj_csr_idx),
        )
        state0 = NetState(t=0, key=key, neurons=nstate, ring=ring,
                          weights=weights, stp=stp_states, stdp=stdp_states,
                          cond=cond, homeo=homeo_states)
        net = CompiledNetwork(static=static, params=_to_device(params, device),
                              state0=_to_device(state0, device), ledger=ledger,
                              policy=policy)
        if partition is not None:
            from repro_torch.core.partition import plan_partition

            net.partition = plan_partition(net, partition)
        return net


# How many × fewer bytes the CSR layout must touch per tick before a
# projection is auto-assigned the sparse gather: dense reads 4·pre·post
# bytes (the hoisted f32 image), CSR reads ≤ 8·post·fanin (index + hoisted
# f32 weight). A plastic projection adds its STDP traffic, about 5 B per
# cell on either side (weight read and write, mask byte).
_SPARSE_ADVANTAGE = 4.0

# Above this many pre×post cells a projection skips the dense host-side
# mask build and samples CSR fan-in rows directly (`build_csr_direct`).
_DENSE_BUILD_CELLS = 1 << 25


def _csr_wins(spec: ProjectionSpec) -> bool:
    """Cost model: bytes touched per tick, dense image vs CSR fan-in rows."""
    area_dense = spec.pre_size * spec.post_size
    area_csr = spec.post_size * max(spec.fanin, 1)
    dense_bytes, csr_bytes = 4 * area_dense, 8 * area_csr
    if spec.plastic:
        dense_bytes += 5 * area_dense
        csr_bytes += 5 * area_csr
    return dense_bytes >= _SPARSE_ADVANTAGE * csr_bytes


def ring_channel(spec: ProjectionSpec, channels: int) -> int:
    """The ring channel a projection delivers into: 1 for an inhibitory one
    on a two-channel (COBA) ring, else 0."""
    return 0 if channels == 1 or spec.receptor == "exc" else 1


def _plan_buckets(
    specs: tuple[ProjectionSpec, ...], channels: int, pack_density: float,
    propagation: str = "packed",
) -> tuple[tuple[BucketSpec, ...], tuple[torch.Tensor, ...],
           tuple[torch.Tensor, ...]]:
    """Compile-time propagation plan for non-plastic, non-STP projections.

    Each such projection goes sparse (one ``kind="sparse"`` bucket) when forced
    by ``"sparse"`` or picked by ``"auto"``'s cost model (``"packed"`` and
    ``"loop"`` keep them all dense); the rest are grouped by (delay, ring
    channel), the channel 1 for inhibitory projections of a two-channel
    (COBA) ring and 0 else, and each group lowers to ONE block-dense matmul over
    the sorted union of its pre/post ranges when the member blocks fill at
    least ``pack_density`` of the union rectangle. Otherwise projections
    sharing a pre range merge when they fill it densely enough, and the
    rest get a bucket each.
    """
    grouped: dict[tuple[int, int], list[int]] = {}
    sparse_js: list[int] = []
    for j, s in enumerate(specs):
        if s.plastic or s.stp is not None:
            continue
        if propagation == "sparse" or (propagation == "auto" and _csr_wins(s)):
            sparse_js.append(j)
        else:
            grouped.setdefault((s.delay_ms, ring_channel(s, channels)), []).append(j)

    buckets: list[BucketSpec] = []
    pre_ids: list[torch.Tensor] = []
    post_ids: list[torch.Tensor] = []
    empty = torch.zeros((0,), dtype=torch.int32)

    for j in sparse_js:
        s = specs[j]
        buckets.append(BucketSpec(
            delay_ms=s.delay_ms, channel=ring_channel(s, channels), p=s.pre_size, q=s.post_size,
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
    # Set by compile(partition=PartitionSpec(...)): the core-grid plan the
    # Engine runs the net through (repro_torch.core.partition).
    partition: object | None = None

    @property
    def n_neurons(self) -> int:
        return self.static.n

    @property
    def n_synapses(self) -> int:
        return int(sum(s.n_syn for s in self.static.projections))
