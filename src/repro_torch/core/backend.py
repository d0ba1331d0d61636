"""The tick's hot phases: neuron update, propagation and plasticity.

Every bucket of the compile-time plan (``NetStatic.buckets``) is either a
dense ``[P, Q]`` matmul on the tick's spike row (``syn_matmul``, through
the run's :class:`repro_torch.kernels.ops.MatmulRun`, built by
:func:`assemble_matmul`) or a CSR fan-in gather (``syn_gather``, every
sparse bucket of a tick in one launch through the run's
:class:`repro_torch.kernels.ops.GatherRun`, built by
:func:`assemble_gather`); the neuron phase of IZH4-only Euler networks is
the ``izh4_update`` kernel, a run's whole neuron phase of a tick in one
launch through its :class:`repro_torch.kernels.ops.NeuronRun` (built by
:func:`assemble_neurons`). Plastic and STP projections, whose weights
change every tick, drive through :class:`PlasticDrive` after the buckets,
and pair-based STDP updates their weights through ``stdp_update`` (dense
storage) or ``stdp_gather`` (CSR fan-in rows) in :func:`stdp_dispatch`; the
plastic drive is one ``plastic_drive`` launch per tick over every such
projection (:class:`PlasticDrive`, an :class:`repro_torch.kernels.ops.DriveRun`
landing in the tick's accumulators); a
run's CSR pair-STDP projections update in one ``stdp_gather`` launch per
tick, trace steps included, through its
:class:`repro_torch.kernels.ops.StdpGatherRun` (built by
:func:`assemble_stdp_gather`), and its dense-stored ones in one
``stdp_update`` launch per tick through its
:class:`repro_torch.kernels.ops.StdpUpdateRun` (built by
:func:`assemble_stdp_update`).
``backend="fused"`` assembles its payload here (:func:`assemble_fused`):
the whole tick is then the ``fused_tick`` kernel where the plan allows it,
and the phases above where it does not. ``propagation="loop"`` nets
propagate through :func:`propagate_loop`, the oracle: one plain product
and one ring commit per projection.

Conductance-based (COBA) nets have a two-channel ring: every drive lands
as its absolute value in channel 0 (excitatory projections) or 1
(inhibitory ones), bucket by bucket and projection by projection, as in
the reference; their neuron phase decays and delivers the conductances
(:class:`repro_torch.kernels.ops.NeuronRun`'s COBA mode).
The wrappers in :mod:`repro_torch.kernels.ops` launch the CUDA kernels for
tensors on the card and run their plain PyTorch versions for tensors on
the CPU, so this module has one code path.

Lanes: the launchers and :func:`propagate_packed` also take B independent
lanes of one static net (a leading ``[B]`` axis on the spikes, the ring,
the accumulators, the plastic and STP state and, where each lane holds its
own, the weights), each lane at its own tick (:class:`LaneSlots`), one
launch per kernel for all of them; ``engine.run_batch`` and
``serve.LaneScheduler`` drive them.

Two departures from the reference, both bitwise neutral:

* Buckets run ungated. The reference skips a bucket whose pre spikes are
  all silent (``lax.cond``); a silent bucket adds exact zeros into an
  accumulator that starts at +0.0 and so is never -0.0, and the reference
  asserts that gating changes no bit. In eager PyTorch the predicate would
  cost a device-to-host sync per bucket per tick.
* The ring is updated in place: the tick writes its commits into the
  caller's ring tensor (``engine.run`` owns a private copy).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import neurons as nrn
from repro_torch.core.conductance import decay_factors
from repro_torch.core.network import ring_channel
from repro_torch.core.plasticity import STDPState, _trace_step
from repro_torch.core.synapses import ProjectionParams, propagate, stp_update
from repro_torch.kernels import ops
from repro_torch.kernels.fused_tick import KernelPayload, assemble_kernel
from repro_torch.kernels.izh_update import CobaCoeffs
from repro_torch.kernels.plastic_drive import DriveProjection
from repro_torch.kernels.ref import xla_cpu_row_sum
from repro_torch.kernels.stdp_gather import Projection
from repro_torch.kernels.stdp_update import DenseProjection
from repro_torch.kernels.syn_gather import Bucket

__all__ = ["assemble_packed", "assemble_matmul", "assemble_gather", "assemble_neurons",
           "LanePropagation", "LaneSlots",
           "coba_coeffs", "update_neurons_dispatch", "propagate_packed", "propagate_loop",
           "FaninRows", "assemble_fanin", "PlasticDrive", "assemble_drive",
           "xla_cpu_row_sum", "stdp_dispatch", "assemble_stdp_gather",
           "assemble_stdp_update", "FusedPayload", "assemble_fused"]

f32 = torch.float32


def assemble_packed(static, weights) -> tuple[torch.Tensor, ...]:
    """The per-bucket f32 weight payloads, decoded once per run.

    Dense buckets get their block-dense ``[P, Q]`` image; sparse buckets
    their CSR weight rows ``[Q, fanin]`` decoded to f32. Weights with a
    leading lane axis (``[B, ...]``, each lane's own) give payloads with
    one, ``[B, P, Q]`` and ``[B, Q, fanin]``.
    """
    packed = []
    for b in static.buckets:
        j0 = b.members[0][0]
        spec0 = static.projections[j0]
        if b.kind == "sparse" or (len(b.members) == 1 and (b.p, b.q) == (
                spec0.pre_size, spec0.post_size)):
            # The decode is the payload: no zero-filled image.
            packed.append(weights[j0].to(f32).contiguous())
            continue
        lead = tuple(weights[j0].shape[:-2])
        img = torch.zeros((*lead, b.p, b.q), dtype=f32, device=weights[j0].device)
        for j, r0, c0 in b.members:
            spec = static.projections[j]
            img[..., r0:r0 + spec.pre_size, c0:c0 + spec.post_size] += weights[j].to(f32)
        packed.append(img)
    return tuple(packed)


def assemble_matmul(static, packed, lanes: int | None = None) -> ops.MatmulRun:
    """The run's ``syn_matmul`` launcher over the dense buckets' images in
    ``packed`` (:func:`assemble_packed`'s output), over ``lanes`` lanes
    where given. Plastic and STP projections join no bucket, so the images
    stay fixed for the run."""
    return ops.MatmulRun([None if b.kind == "sparse" else w
                          for b, w in zip(static.buckets, packed)], lanes)


def assemble_gather(static, params, packed, lanes: int | None = None) -> ops.GatherRun:
    """The run's ``syn_gather`` launcher over the sparse buckets' CSR
    tables (``params.bucket_csr_idx``, weights from ``packed``, pre ids
    composed through ``bucket_pre_ids`` where ``pre_start < 0``), with the
    whole plan's post columns (``bucket_post_ids`` where ``post_start <
    0``) deciding its launch groups; built once per run, as
    :func:`assemble_matmul`, over ``lanes`` lanes where given."""
    buckets = []
    for bi, b in enumerate(static.buckets):
        posts = (np.arange(b.post_start, b.post_start + b.q) if b.post_start >= 0
                 else params.bucket_post_ids[bi].cpu().numpy())
        table = None
        if b.kind == "sparse":
            pre = (np.arange(b.pre_start, b.pre_start + b.p) if b.pre_start >= 0
                   else params.bucket_pre_ids[bi].cpu().numpy())
            table = (pre, params.bucket_csr_idx[bi], packed[bi])
        buckets.append(Bucket(b.delay_ms, posts, table, b.channel))
    return ops.GatherRun(static.n, buckets, params.neuron.a.device, static.ring_channels,
                         lanes)


class LanePropagation:
    """The propagation launchers of B lanes of a net (:func:`assemble_packed`'s
    payloads, :func:`assemble_matmul` and :func:`assemble_gather` over
    ``lanes``; for a ``fused_tick`` net the kernel's payload ``kernel``
    instead), built once on ``weights``: the weights every lane shares
    (one-lane tensors) or each lane's own (``[B, ...]``). A caller that
    keeps them across runs (``serve.LaneScheduler``) writes a lane's new
    weights in with :meth:`set_lane`; the index plan, which depends on the
    static net only, is built once. Plastic and STP projections join no
    bucket: their launchers are built per run on the lanes' weights."""

    def __init__(self, static, params, weights, lanes: int):
        self.static, self.params = static, params
        self.packed = assemble_packed(static, weights)
        self.matmul = self.gather = self.kernel = None
        if static.fused_kernel:
            self.kernel = assemble_kernel(static, params, self.packed)
        else:
            self.matmul = assemble_matmul(static, self.packed, lanes)
            self.gather = assemble_gather(static, params, self.packed, lanes)

    def set_lane(self, lane: int, weights) -> None:
        """Lane ``lane``'s payloads decoded from its one-lane ``weights``,
        written in place (per-lane payloads only)."""
        for dst, src in zip(self.packed, assemble_packed(self.static, weights)):
            if dst.dim() == src.dim():
                raise ValueError("LanePropagation.set_lane: the lanes share their weights")
            dst[lane].copy_(src)
        if self.kernel is not None:
            one = assemble_kernel(self.static, self.params,
                                  tuple(w[lane] for w in self.packed))
            self.kernel.wd[lane].copy_(one.wd)
            self.kernel.wc[lane].copy_(one.wc)
        else:
            self.gather.set_lane(lane)


def coba_coeffs(static) -> CobaCoeffs:
    """The COBA neuron phase's coefficients of a net with ``static.coba``:
    the decay factors of :func:`repro_torch.core.conductance.decay_factors`,
    the delivery fractions and the reversal potentials, each the f32 value
    of the configuration's double, as the reference's weak-typed scalars
    enter."""
    cfg = static.coba

    def as_f32(x: float) -> float:
        return float(torch.tensor(x, dtype=f32))

    return CobaCoeffs(
        decay=decay_factors(cfg, static.dt),
        frac=tuple(as_f32(x) for x in (1.0 - cfg.nmda_frac, cfg.nmda_frac,
                                        1.0 - cfg.gabab_frac, cfg.gabab_frac)),
        e_exc=as_f32(cfg.e_exc), e_gabaa=as_f32(cfg.e_gabaa),
        e_gabab=as_f32(cfg.e_gabab))


def assemble_neurons(static, params, neurons: nrn.NeuronState, ring: torch.Tensor, *,
                     cond=None, gen_spk=None, i_ext=None, raster=None, v_rows=None,
                     i_rows=None, counts=None, t0=None, tel=None) -> ops.NeuronRun | None:
    """The run's neuron-phase launcher (an :class:`repro_torch.kernels.ops.NeuronRun`
    on copies of ``neurons`` and, for a COBA net, of its conductances
    ``cond``, and on the run's ``ring``) for IZH4-only Euler networks, None
    for the others, which integrate through :func:`update_neurons_dispatch`
    tick by tick. ``gen_spk`` ``[T, n_gen]`` holds the generator spans'
    spikes side by side in ``static.gen_spans`` order; the other rows and
    ``counts`` are ``NeuronRun``'s, as is ``t0``, the lanes' first ticks of
    a run over lanes; ``tel`` its in-run monitor slots (``tel_count``,
    ``tel_rate`` and ``rate``, a dict; None for none)."""
    if not (static.izh4_only and static.method == "euler"):
        return None
    p = params.neuron
    cols = None
    if gen_spk is not None:
        cols = torch.full((static.n,), -1, dtype=torch.int64, device=p.a.device)
        off = 0
        for g0, sz in static.gen_spans:
            cols[g0:g0 + sz] = torch.arange(off, off + sz, device=p.a.device)
            off += sz
    return ops.NeuronRun(neurons.v, neurons.u, neurons.refrac, ring,
                         p.model == nrn.NeuronModel.GENERATOR, p.a, p.b, p.c, p.d,
                         gen_spk=gen_spk, gen_cols=cols, i_ext=i_ext, raster=raster,
                         v_rows=v_rows, i_rows=i_rows, counts=counts, cond=cond,
                         coba=None if static.coba is None else coba_coeffs(static),
                         dt=static.dt, substeps=static.substeps, t0=t0, **(tel or {}))


def update_neurons_dispatch(static, params, neurons: nrn.NeuronState,
                            i_syn: torch.Tensor):
    """Neuron integration step; returns ``(neurons', spiked)``.

    IZH4-only Euler networks (the Synfire workloads) take the
    ``izh4_update`` kernel; generators then hold rest and never spike on
    their own, and a refractory countdown masks the spike flag, as in the
    reference's fast path. Everything else takes the generic
    :func:`repro_torch.core.neurons.update_neurons`.
    """
    state_dtype = neurons.v.dtype
    if not (static.izh4_only and static.method == "euler"):
        return nrn.update_neurons(
            params.neuron, neurons, i_syn, dt=static.dt,
            substeps=static.substeps, method=static.method,
            state_dtype=state_dtype)
    p = params.neuron
    v, u, spiked = ops.izh4_update(neurons.v, neurons.u, i_syn, p.a, p.b,
                                   p.c, p.d, dt=static.dt,
                                   substeps=static.substeps)
    is_gen = p.model == nrn.NeuronModel.GENERATOR
    spiked = spiked & ~is_gen & ~(neurons.refrac > 0)
    v = torch.where(is_gen, p.c, v.to(f32)).to(state_dtype)
    u = torch.where(is_gen, 0.0, u.to(f32)).to(state_dtype)
    refrac = torch.clamp_min(neurons.refrac - 1, 0)
    return nrn.NeuronState(v=v, u=u, refrac=refrac), spiked


class FaninRows(NamedTuple):
    """Gather tables of one plastic or STP projection's fan-in-row drive,
    built once per run from ``params.proj_csr_idx``: ``pre`` ``[Q, F]``
    int64 indices into the tick's spike row (global ids for plastic
    projections, with the sentinel pad pointing at the zero appended after
    the row; local ids for STP ones, whose pre row is scaled first), and,
    for dense-stored projections, ``rows`` ``[Q, F]`` int64 indices into
    the flattened ``[P, Q]`` weight with a zero appended (None for
    CSR-stored ones)."""

    pre: torch.Tensor
    rows: torch.Tensor | None


def assemble_fanin(static, params) -> tuple[FaninRows | None, ...]:
    """Per projection, the :class:`FaninRows` of plastic and STP
    projections (None for the others)."""
    out = []
    for j, spec in enumerate(static.projections):
        if not (spec.plastic or spec.stp is not None):
            out.append(None)
            continue
        idx = params.proj_csr_idx[j].long()
        if spec.stp is not None:
            out.append(FaninRows(pre=idx, rows=None))
            continue
        pad = idx >= spec.pre_size  # the sentinel of dense-stored tables
        pre = torch.where(pad, static.n, idx + spec.pre_start)
        rows = None
        if j not in static.csr_projs:
            q = spec.post_size
            cols = torch.arange(q, device=idx.device)[:, None]
            rows = torch.where(pad, spec.pre_size * q, idx * q + cols)
        out.append(FaninRows(pre=pre, rows=rows))
    return tuple(out)


class PlasticDrive:
    """A run's fan-in drive of its plastic and STP projections (``keys``,
    in projection order): an :class:`repro_torch.kernels.ops.DriveRun`
    (``run``) whose drives land where :func:`propagate_packed` accumulates
    their delay, in the projection's channel (1 for an inhibitory
    projection of a COBA net): in ``gather``'s accumulator rows where that
    launcher holds the delay, else in accumulators of its own (``own``,
    delay → ``[(B,) N, C]``, zeroed by :meth:`start` every tick). Sums in
    the reference's order (:func:`xla_cpu_row_sum`) on both devices, so
    the card's drive equals the CPU port's bit for bit. Built per run (per
    chunk over ``lanes``) after ``gather``, on ``weights`` and ``stp`` for
    their storage dtypes."""

    def __init__(self, static, params, weights, stp, gather, fanin=None,
                 lanes: int | None = None):
        fanin = fanin if fanin is not None else assemble_fanin(static, params)
        n_ch = static.ring_channels
        lead = () if lanes is None else (lanes,)
        self.keys = tuple(j for j, s in enumerate(static.projections)
                          if s.plastic or s.stp is not None)
        held = set(gather.delays) if gather.starts else set()
        mine = sorted({static.projections[j].delay_ms for j in self.keys} - held)
        self._own = torch.zeros((len(mine), *lead, static.n, n_ch), dtype=f32,
                                device=params.neuron.a.device)
        self.own = {d: self._own[k] for k, d in enumerate(mine)}
        projs = []
        for j in self.keys:
            spec, fr = static.projections[j], fanin[j]
            if spec.delay_ms in held:
                k = gather.delays.index(spec.delay_ms)
                acc = gather.rows[..., k * n_ch:(k + 1) * n_ch, :].transpose(-1, -2)
            else:
                acc = self.own[spec.delay_ms]
            out = acc[..., spec.post_start:spec.post_start + spec.post_size,
                      ring_channel(spec, n_ch)]
            projs.append(DriveProjection(
                pre=fr.pre, rows=fr.rows, out=out, w_dtype=weights[j].dtype,
                sentinel=spec.pre_size * spec.post_size if fr.rows is not None else -1,
                stp=spec.stp is not None, pre_start=spec.pre_start, n_pre=spec.pre_size,
                stp_dtype=stp[j].u.dtype if spec.stp is not None else f32))
        self.run = ops.DriveRun(static.n, projs, lanes=lanes, coba=n_ch == 2)

    def start(self, acc: dict) -> None:
        """The tick's own accumulators, zeroed, into ``acc`` (delay → its
        ``[(B,) N, C]`` accumulator), before any bucket adds there."""
        if self.own:
            self._own.zero_()
            acc.update(self.own)


def assemble_drive(static, params, weights, stp, gather, fanin=None,
                   lanes: int | None = None) -> PlasticDrive | None:
    """The run's :class:`PlasticDrive` (on ``gather``, :func:`assemble_gather`'s
    launcher of the same run), None for a net with no plastic or STP
    projection."""
    if not any(s.plastic or s.stp is not None for s in static.projections):
        return None
    return PlasticDrive(static, params, weights, stp, gather, fanin, lanes)


def _bucket_pre(static, params, spikes_f32, bi):
    b = static.buckets[bi]
    if b.pre_start >= 0:
        return spikes_f32[..., b.pre_start:b.pre_start + b.p]
    return spikes_f32.index_select(-1, params.bucket_pre_ids[bi])


class LaneSlots:
    """The ring commits of a run over B lanes whose first ticks are ``t0``
    (Python ints): run tick ``i``'s commit for delay ``d`` adds into lane
    b's slot ``(t0[b] + i + d) % ring_len``. Lanes in one phase (every
    ``t0`` equal mod ``ring_len``, as a batched run's) add into one slot
    column of the ``[B, L, N, C]`` ring; lanes in different phases (a
    scheduler's) gather their slots, add and scatter them back, through
    per-phase index tensors built here once. Either way each lane's entry
    is ``row + x`` in the ring's dtype, the one-lane commit's rounding."""

    def __init__(self, t0: tuple[int, ...], ring_len: int, device):
        self.t0, self.ring_len = tuple(t0), ring_len
        self._phase = None
        if len({t % ring_len for t in self.t0}) > 1:
            lanes = torch.arange(len(self.t0), dtype=torch.int64) * ring_len
            first = torch.tensor(self.t0, dtype=torch.int64)
            self._phase = [(lanes + (first + s) % ring_len).to(device)
                           for s in range(ring_len)]

    def add(self, ring: torch.Tensor, tick: int, x: torch.Tensor) -> None:
        """``ring`` ``[B, L, N, C]`` += ``x`` ``[B, N, C]`` (the ring's
        dtype) at every lane's slot of run tick ``tick`` (delay included)."""
        if self._phase is None:
            ring[:, (self.t0[0] + tick) % self.ring_len] += x
            return
        flat = ring.view(-1, *ring.shape[2:])
        rows = self._phase[tick % self.ring_len]
        flat[rows] += x


def propagate_packed(static, params, spikes_f32: torch.Tensor, ring: torch.Tensor,
                     t: int, packed, weights=(), stp=(), fanin=None,
                     matmul=None, gather=None, padded=None,
                     slots: LaneSlots | None = None,
                     drive: PlasticDrive | None = None) -> tuple:
    """Propagate this tick's spikes (``[N]`` f32, 0.0/1.0) into ``ring``.

    Each bucket's drive lands in a per-delay ``[N, C]`` f32 accumulator
    (``C = static.ring_channels``) in plan order, in its bucket's channel:
    the sparse buckets' through ``gather``, whose accumulator rows become
    those of their delays (its group 0 writes them before the first
    bucket, a later group adds where it stands), the dense buckets'
    through ``matmul``; then every plastic or STP projection's fan-in-row
    drive (``drive``, a :class:`PlasticDrive`, one launch for all of them,
    on ``weights[j]``, the pre row scaled by ``u · x`` for STP) lands in
    the same accumulators, in projection order, in channel 1 for an
    inhibitory projection of a COBA net and 0 else; a COBA drive lands as
    its absolute value. Then one commit per
    distinct delay adds each accumulator, cast to the ring's dtype first,
    into ring slot ``(t + d) % ring_len`` (the reference's ``row +
    acc.astype(ring.dtype)``). ``fanin`` is
    :func:`assemble_fanin`'s output (read when ``drive`` is built here),
    ``matmul`` :func:`assemble_matmul`'s, ``gather``
    :func:`assemble_gather`'s and ``drive`` a :class:`PlasticDrive` on
    ``gather``, each built here when omitted; ``padded`` maps projection
    ids to the flat zero-ended weight buffers their dense weights start
    (``ops.StdpUpdateRun.padded``), which the drive reads in their place.
    Updates ``ring`` in place; returns the STP states advanced by this
    tick's spikes, aligned with the projections.

    Over B lanes (``slots`` given): the spikes are ``[B, N]``, the ring
    ``[B, L, N, C]``, the accumulators ``[B, N, C]``, the plastic weights
    and STP states ``[B, ...]``, ``matmul``, ``gather`` and ``drive`` are
    lane launchers, ``t`` is the run's tick index and each lane commits
    into its own slot through ``slots``; every lane's sums and roundings
    are those of its one-lane tick.
    """
    acc: dict[int, torch.Tensor] = {}
    if matmul is None:
        matmul = assemble_matmul(static, packed)
    if gather is None:
        gather = assemble_gather(static, params, packed)
    n_ch = static.ring_channels
    coba = n_ch == 2
    lead = tuple(spikes_f32.shape[:-1])
    per_proj = [j for j, s in enumerate(static.projections) if s.plastic or s.stp is not None]
    if per_proj and drive is None:
        drive = assemble_drive(static, params, weights, stp, gather, fanin,
                               lead[0] if lead else None)
    if per_proj:
        drive.start(acc)

    def add(delay_ms, channel, post_start, q, drive, post_ids=None):
        a = acc.get(delay_ms)
        if a is None:
            a = acc[delay_ms] = torch.zeros((*lead, static.n, n_ch), dtype=f32,
                                            device=spikes_f32.device)
        if coba:
            drive = drive.abs()
        if post_start >= 0:
            a[..., post_start:post_start + q, channel] += drive
        else:
            a[..., channel].index_add_(-1, post_ids, drive)

    if gather.starts:
        gather(0, spikes_f32)
        acc.update((d, gather.rows[..., k * n_ch:(k + 1) * n_ch, :].transpose(-1, -2))
                   for k, d in enumerate(gather.delays))
    later = {i: g for g, i in enumerate(gather.starts) if g}
    for bi, b in enumerate(static.buckets):
        if bi in later:
            gather(later[bi], spikes_f32)
        if b.kind == "sparse":
            continue
        add(b.delay_ms, b.channel, b.post_start, b.q,
            matmul(bi, _bucket_pre(static, params, spikes_f32, bi)),
            params.bucket_post_ids[bi])

    stp = stp or (None,) * len(static.projections)
    new_stp = list(stp)
    if per_proj:
        padded = padded or {}
        drive.run(spikes_f32, [padded.get(j, weights[j]) for j in per_proj],
                  [None if stp[j] is None else (stp[j].u, stp[j].x) for j in per_proj])
        for j in per_proj:
            spec = static.projections[j]
            if spec.stp is not None:
                new_stp[j] = stp_update(spec.stp, stp[j], spikes_f32[..., spec.pre_slice],
                                        static.dt)
    for d in sorted(acc):
        x = acc[d].to(ring.dtype)
        if slots is None:
            ring[(t + d) % static.ring_len] += x
        else:
            slots.add(ring, t + d, x)
    return tuple(new_stp)


def propagate_loop(static, spikes_f32: torch.Tensor, ring: torch.Tensor, t: int,
                   weights, stp) -> tuple:
    """The loop oracle's propagation (``propagation="loop"``), as the
    reference's ``engine._propagate_loop``: projection by projection, its
    drive (:func:`repro_torch.core.synapses.propagate`, one plain
    ``torch.matmul`` of the pre row, scaled by ``u · x`` for STP, with the
    dense weights), its absolute value on a COBA net, is cast to the ring's
    dtype and added into its post columns and channel of ring slot ``(t +
    delay) % ring_len``: one rounding per projection, where
    :func:`propagate_packed` rounds once per delay (the two agree on
    exactly representable tables). Updates ``ring`` in place; returns the
    STP states advanced by this tick's spikes, aligned with the
    projections."""
    n_ch = static.ring_channels
    new_stp = []
    for spec, w, st in zip(static.projections, weights, stp or (None,) * len(weights)):
        contrib = propagate(spec, ProjectionParams(weight=w, mask=None), spikes_f32, st)
        if n_ch == 2:
            contrib = contrib.abs()
        ring[(t + spec.delay_ms) % static.ring_len, spec.post_slice,
             ring_channel(spec, n_ch)] += contrib.to(ring.dtype)
        new_stp.append(None if st is None
                       else stp_update(spec.stp, st, spikes_f32[spec.pre_slice], static.dt))
    return tuple(new_stp)


def stdp_dispatch(static, cfg, tr: STDPState, w: torch.Tensor, mask: torch.Tensor,
                  pre_sp: torch.Tensor, post_sp: torch.Tensor,
                  idx: torch.Tensor | None = None) -> tuple[STDPState, torch.Tensor]:
    """One tick of pair-based STDP (``cfg.tau_elig`` None) on either storage:
    the traces advance (:func:`repro_torch.core.plasticity._trace_step`),
    then ``stdp_update`` updates dense ``[pre, post]`` weights under their
    mask (``idx`` None), or ``stdp_gather`` CSR fan-in rows ``[post,
    fanin]`` over ``idx`` under their validity rows (``mask``). Spikes are
    f32 0.0/1.0. Returns ``(state', w')``."""
    pre_t = _trace_step(tr.pre_trace, pre_sp, cfg.tau_plus, static.dt)
    post_t = _trace_step(tr.post_trace, post_sp, cfg.tau_minus, static.dt)
    kw = dict(a_plus=cfg.a_plus, a_minus=cfg.a_minus, w_min=cfg.w_min,
              w_max=cfg.w_max)
    if idx is None:
        w2 = ops.stdp_update(w, mask, pre_t, post_t, pre_sp, post_sp, **kw)
    else:
        w2 = ops.stdp_gather(w, idx, mask, pre_t, post_t, pre_sp, post_sp, **kw)
    return STDPState(pre_trace=pre_t, post_trace=post_t), w2


def _pair_stdp(static, stdp, dense: bool):
    """Per pair-STDP projection (``cfg.tau_elig`` None) of one storage
    (dense-stored when ``dense``, else CSR-stored), in projection order:
    its id and the run-launcher fields it shares with the other storage,
    on copies of its ``stdp`` traces (each a ping-pong pair)."""
    for j, cfg in enumerate(static.stdp):
        if cfg is None or cfg.tau_elig is not None or (j in static.csr_projs) == dense:
            continue
        spec, tr = static.projections[j], stdp[j]
        yield j, dict(
            pre_tr=(tr.pre_trace.clone(), torch.empty_like(tr.pre_trace)),
            post_tr=(tr.post_trace.clone(), torch.empty_like(tr.post_trace)),
            pre_start=spec.pre_start, post_start=spec.post_start, a_plus=cfg.a_plus,
            a_minus=cfg.a_minus, w_min=cfg.w_min, w_max=cfg.w_max,
            decay_pre=math.exp(-static.dt / cfg.tau_plus),
            decay_post=math.exp(-static.dt / cfg.tau_minus))


def assemble_stdp_gather(static, params, weights, stdp,
                         lanes: int | None = None) -> ops.StdpGatherRun | None:
    """The run's ``stdp_gather`` launcher over its CSR-stored pair-STDP
    projections (``cfg.tau_elig`` None, ``j in static.csr_projs``), on
    copies of their ``weights`` and ``stdp`` traces, keyed by projection id;
    None where there is none. Over ``lanes``, the weights and traces are
    each lane's own (``[B, ...]``). DA-STDP stays on its per-call steps."""
    projs, keys = [], []
    for j, fields in _pair_stdp(static, stdp, dense=False):
        projs.append(Projection(w=weights[j].clone(), idx=params.proj_csr_idx[j],
                                valid=params.masks[j], **fields))
        keys.append(j)
    return ops.StdpGatherRun(static.n, projs, keys, lanes) if projs else None


def assemble_stdp_update(static, params, weights, stdp,
                         lanes: int | None = None) -> ops.StdpUpdateRun | None:
    """The run's ``stdp_update`` launcher over its dense-stored pair-STDP
    projections (``cfg.tau_elig`` None, ``j not in static.csr_projs``), on
    copies of their ``weights`` and ``stdp`` traces, keyed by projection
    id; None where there is none. Each copy is the start of a flat ``[P·Q +
    1]`` buffer ending in +0.0 (``padded``; over ``lanes`` one such row per
    lane, ``[B, P·Q + 1]``), which the fan-in drive reads. DA-STDP stays on
    its per-call steps, as the reference keeps it plain on both backends."""
    projs, keys = [], []
    for j, fields in _pair_stdp(static, stdp, dense=True):
        w = weights[j]
        lead = tuple(w.shape[:-2])
        padded = w.new_zeros((*lead, w.shape[-2] * w.shape[-1] + 1))
        padded[..., :-1].copy_(w.reshape(*lead, -1))
        projs.append(DenseProjection(w=padded[..., :-1].view(w.shape), mask=params.masks[j],
                                     padded=padded, **fields))
        keys.append(j)
    return ops.StdpUpdateRun(static.n, projs, keys, lanes) if projs else None


class FusedPayload(NamedTuple):
    """Loop-invariant payloads of ``backend="fused"``, built once per run.

    ``packed`` is :func:`assemble_packed`'s per-bucket tuple, which the
    ticks that are not one kernel (IZH9 or LIF groups, RK4, gathered or
    scattered buckets, plastic or STP projections, an external current)
    propagate with
    :func:`propagate_packed`; ``kernel`` is the ``fused_tick`` kernel's
    payload when ``static.fused_kernel`` is set (else ``None``)."""

    packed: tuple[torch.Tensor, ...]
    kernel: KernelPayload | None = None


def assemble_fused(static, weights, params=None) -> FusedPayload:
    """The fused payloads: the packed bucket payloads and, with ``params``
    given and ``static.fused_kernel`` set, the kernel's payload."""
    packed = assemble_packed(static, weights)
    kernel = (assemble_kernel(static, params, packed)
              if static.fused_kernel and params is not None else None)
    return FusedPayload(packed=packed, kernel=kernel)
