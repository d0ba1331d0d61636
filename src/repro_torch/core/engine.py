"""Simulation engine: the 1 ms tick and the run loop.

Order of operations per tick follows CARLsim's kernel, as the reference's
``step`` does:

  1. read the delay-ring slot for tick t (the currents that arrive now)
     and zero it
  2. CUBA: the current is the signed slot; COBA: the conductances decay,
     take the slot's excitatory and inhibitory deliveries, and give the
     current at the membrane potential (+ optional external current)
  3. integrate the neurons, detect and reset spikes (``izh4_update``)
  4. merge the Poisson generators' spikes
  5. propagate the spikes through every bucket into slot (t + d) mod D
     (``syn_matmul`` / ``syn_gather``), then through the plastic and STP
     projections' fan-in rows, one ring commit per delay (the ``loop``
     oracle: one plain product and one ring commit per projection)
  6. plasticity: pair-based STDP on the plastic projections
     (``stdp_update`` on dense storage, ``stdp_gather`` on CSR rows), or
     DA-STDP gated by the tick's dopamine

and, every ``homeo_period`` ticks, homeostatic scaling of the weights of
the projections that carry it, from the segment's spike counts (counted on
the device, so no tick reads back).

``run`` is a Python loop over ticks. The tick index is a Python int, the
raster is written into a preallocated ``[T, N]`` bool tensor on the
device, and nothing in the loop reads a tensor back to the host, so on
the card the loop only enqueues work. The generator spikes of the whole
run are computed before the loop in one comparison (they depend only on
the uniforms and the tick), and the bucket weight payloads are decoded
once per run, as are the dense buckets' ``syn_matmul`` launcher
(``ops.MatmulRun``: one ctypes call per product), the sparse buckets'
``syn_gather`` launcher (``ops.GatherRun``: one ctypes call and one
launch per tick for every compiled plan), the neuron phase's
``izh4_update`` launcher of IZH4-only Euler nets (``ops.NeuronRun``:
steps 1-4 and the tick's raster, record and homeostasis-count writes in
one ctypes call and one launch per tick), the CSR pair-STDP projections'
``stdp_gather`` launcher (``ops.StdpGatherRun``: one launch per tick for
all of them, trace steps included) and the dense-stored pair-STDP
projections' ``stdp_update`` launcher (``ops.StdpUpdateRun``, the same
for dense storage) and the plastic and STP projections' fan-in drive
(``backend.PlasticDrive``: one ``plastic_drive`` launch per tick for all
of them). :func:`run_batch` and ``serve.LaneScheduler`` tick B lanes
through the same launchers over a leading lane dimension
(:func:`batched_route`). With
``backend="fused"`` and a plan whose ``kernel_ok`` is set, a tick is one
operation, the ``fused_tick`` kernel, which writes its spike row straight
into the raster; other fused nets (plastic or STP ones among them), and
runs with an external current, tick as the default backend does.

``record="monitors"`` keeps the net's in-run monitors
(:mod:`repro_torch.telemetry.monitors`) through the run: the first
SpikeCount and GroupRate fold inside the neuron kernel's launch
(``ops.NeuronRun`` or ``ops.FusedTickRun``), so the default set adds no
device operation per tick, and the rest fold as plain ops; the per-group
reductions run once, at the end. A net compiled with watches
(:mod:`repro_torch.obs.watch`) keeps them through every run, whatever it
records, the first RateBand, Silent and NonFinite inside the same launch
(the default set adds no device operation per tick either) and the rest,
and the strided weight checks, as plain ops; the final carry comes back as
``outputs["watch_carry"]``.

The generator uniforms come, by default, from the reference's threefry
stream (:mod:`repro_torch.core.rng`): the same seed gives the same raster
in both packages. ``run``'s serving arguments follow the reference's:
``gen_chunk`` draws them chunk by chunk (generator memory O(chunk)),
``gen_base`` from a counter-keyed stream indexed by the absolute tick
(runs are call-split invariant), and ``active`` gates a lane silent.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core import backend as be
from repro_torch.core import neurons as nrn
from repro_torch.core import rng
from repro_torch.core.conductance import (
    ConductanceState,
    coba_current,
    decay_and_deliver,
    decay_factors,
)
from repro_torch.core.lanes import broadcast_state, stack_states
from repro_torch.core.network import CompiledNetwork, NetParams, NetState, NetStatic
from repro_torch.core.neurons import NeuronState
from repro_torch.core.plasticity import (
    STDPState,
    da_stdp_step,
    da_stdp_step_csr,
    homeostasis_step,
    homeostasis_step_csr,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import watch_fold_ref
from repro_torch.obs import watch as wat
from repro_torch.telemetry import monitors as tel

__all__ = ["StepOutput", "step", "run", "run_batch", "batched_route", "Engine"]

f32 = torch.float32

_RECORD_MODES = ("raster", "monitors", "both", "none")
# The refractory counters are int16: subtracting more than this from them
# would wrap around.
_REFRAC_MAX = 32767


class StepOutput(NamedTuple):
    spikes: torch.Tensor  # [N] bool
    v: torch.Tensor  # [N] f32 membrane potential after update
    i_syn: torch.Tensor  # [N] f32 synaptic current delivered this tick


class _Syn(NamedTuple):
    """The synaptic state a tick advances: ``NetState``'s fields of the
    same names."""

    weights: tuple
    stp: tuple
    stdp: tuple


def _gen_spikes(static: NetStatic, params: NetParams, t0,
                gen_u: torch.Tensor) -> torch.Tensor:
    """Generator spikes ``[T, n_gen]`` for ticks ``t0 .. t0+T-1``: generator
    g fires at tick t when ``gen_u[t, g] < rate * (dt / 1000)``, where the
    rate is the pulse rate while ``t_ms < until`` and the sustained rate
    after, ``t_ms`` being the tick in f32 times dt. The same f32 compare
    as the reference's per-tick merge, for all ticks at once. Over lanes,
    ``t0`` is an int64 ``[B]`` tensor of first ticks and ``gen_u`` ``[B,
    T, n_gen]``."""
    dev = gen_u.device
    cols = torch.cat([torch.arange(g0, g0 + sz, device=dev)
                      for g0, sz in static.gen_spans])
    steps = torch.arange(gen_u.shape[-2], dtype=torch.int64, device=dev)
    ticks = torch.as_tensor(t0, device=dev)[..., None] + steps
    t_ms = (ticks.to(f32) * static.dt)[..., None]
    rate = torch.where(t_ms < params.gen_until[cols], params.gen_rate[cols],
                       params.gen_rate_after[cols])
    return gen_u < rate * (static.dt / 1000.0)


def _plasticity(static: NetStatic, params: NetParams, spikes_f32: torch.Tensor,
                weights: tuple, stdp: tuple, dopamine, stdp_runs=()) -> tuple[tuple, tuple]:
    """Phase 6: every STDP-carrying projection's traces and weights advance
    on this tick's spikes. CSR-stored projections update their fan-in rows
    under their validity rows; pair-based STDP goes through ``stdp_runs``
    (the run's ``ops.StdpGatherRun`` and ``ops.StdpUpdateRun``, each in
    place on its own buffers) for the projections they hold, else through
    :func:`repro_torch.core.backend.stdp_dispatch` (the kernels), DA-STDP
    through the plain steps with ``dopamine`` (0.0 when None). The traces
    of ``stdp_runs``' projections live in them, and their entries of
    ``stdp`` are left as they were."""
    if all(cfg is None for cfg in static.stdp):
        return weights, stdp
    held = set()
    for stdp_run in stdp_runs:
        stdp_run(spikes_f32)
        held.update(stdp_run.keys)
    new_w, new_tr = list(weights), list(stdp)
    da = 0.0 if dopamine is None else dopamine
    csr = static.csr_projs
    for j, cfg in enumerate(static.stdp):
        if cfg is None or j in held:
            continue
        spec = static.projections[j]
        pre_sp, post_sp = spikes_f32[..., spec.pre_slice], spikes_f32[..., spec.post_slice]
        mask = params.masks[j]
        idx = params.proj_csr_idx[j] if j in csr else None
        if cfg.tau_elig is None:
            new_tr[j], new_w[j] = be.stdp_dispatch(static, cfg, stdp[j], weights[j],
                                                   mask, pre_sp, post_sp, idx)
        elif idx is None:
            new_tr[j], new_w[j] = da_stdp_step(cfg, stdp[j], weights[j], mask, pre_sp,
                                               post_sp, da, static.dt)
        else:
            new_tr[j], new_w[j] = da_stdp_step_csr(cfg, stdp[j], weights[j], idx, mask,
                                                   pre_sp, post_sp, da, static.dt)
    return tuple(new_w), tuple(new_tr)


def _apply_homeostasis(static: NetStatic, weights: tuple, homeo: tuple,
                       counts: torch.Tensor,
                       active: torch.Tensor | None = None) -> tuple[tuple, tuple]:
    """The slow timer: every projection carrying a homeostasis config scales
    its weights from ``counts``, each neuron's spikes over the elapsed
    segment of ``homeo_period`` ticks, with ``dt`` the segment in ms (so
    the op's rate term is the segment's mean rate in Hz). Dense and CSR
    storage compute the same ``w · scale[post]`` per synapse. ``active``
    (a 0-dim bool tensor) gates the update on the device: an idle lane's
    rates and weights stay as they were. Over B lanes the weights, rates
    and ``counts`` carry a leading ``[B]`` and ``active`` is ``[B]``."""
    chunk_ms = static.homeo_period * static.dt
    csr = static.csr_projs
    new_w, new_h = list(weights), list(homeo)

    def gate(new, old):
        if active is None:
            return new
        return torch.where(active.view(*active.shape, *[1] * (new.dim() - active.dim())),
                           new, old)

    for j, cfg in enumerate(static.homeo):
        if cfg is None:
            continue
        fn = homeostasis_step_csr if j in csr else homeostasis_step
        avg, w = fn(cfg, homeo[j], weights[j], counts[..., static.projections[j].post_slice],
                    chunk_ms)
        new_h[j], new_w[j] = gate(avg, homeo[j]), gate(w, weights[j])
    return tuple(new_w), tuple(new_h)


def _neuron_phase(static: NetStatic, params: NetParams, neurons: NeuronState,
                  ring: torch.Tensor, t: int, gen_row: torch.Tensor | None,
                  i_ext_row: torch.Tensor | None, cond: ConductanceState | None = None,
                  decays=None):
    """Steps 1-4 of tick ``t`` op by op, zeroing the ring slot in place;
    returns (neurons', spikes, i_syn, cond'). A COBA net's conductances
    decay and take the slot's channels (``decays``: the factors of
    :func:`repro_torch.core.conductance.decay_factors`, computed when
    omitted), and the current comes from them and the v before the update.
    ``run`` takes these steps through the run's ``ops.NeuronRun`` where
    the net allows it."""
    slot = t % static.ring_len
    deliver = ring[slot].to(f32, copy=True)  # [N, C]
    ring[slot].zero_()
    if static.coba is not None:
        cond = decay_and_deliver(static.coba, cond, deliver[:, 0], deliver[:, 1],
                                 static.dt, decays)
        i_syn = coba_current(static.coba, cond, neurons.v)
    else:
        i_syn = deliver[:, 0]
    if i_ext_row is not None:
        i_syn = i_syn + i_ext_row.to(f32)
    neurons, spikes = be.update_neurons_dispatch(static, params, neurons, i_syn)
    if gen_row is not None:
        off = 0
        for g0, sz in static.gen_spans:
            spikes[g0:g0 + sz] = gen_row[off:off + sz]
            off += sz
    return neurons, spikes, i_syn, cond


def _synaptic_phase(static: NetStatic, params: NetParams, spikes_f32: torch.Tensor,
                    ring: torch.Tensor, t: int, packed, syn: _Syn, fanin, matmul, gather,
                    dopamine=None, stdp_runs=(), padded=None, drive=None,
                    slots=None) -> _Syn:
    """Steps 5-6 of tick ``t`` on its f32 spike row, updating ``ring`` in
    place; returns syn'. ``padded``, ``drive`` and ``slots`` (B lanes: the
    spike rows ``[B, N]``, ``t`` the run's tick index) are
    ``propagate_packed``'s; the loop oracle takes none of ``packed``,
    ``fanin``, ``matmul``, ``gather``, ``drive``."""
    if static.propagation == "loop":
        stp = be.propagate_loop(static, spikes_f32, ring, t, syn.weights, syn.stp)
    else:
        stp = be.propagate_packed(static, params, spikes_f32, ring, t, packed,
                                  syn.weights, syn.stp, fanin, matmul, gather, padded,
                                  slots, drive)
    weights, stdp = _plasticity(static, params, spikes_f32, syn.weights, syn.stdp,
                                dopamine, stdp_runs)
    return _Syn(weights, stp, stdp)


def _check_gen_u(gen_u: torch.Tensor, shape, device) -> None:
    if gen_u.shape != shape or gen_u.dtype != f32 or gen_u.device != device:
        raise ValueError(
            f"gen_u must be float32 {tuple(shape)} on {device}, got "
            f"{gen_u.dtype} {tuple(gen_u.shape)} on {gen_u.device}")


def step(static: NetStatic, params: NetParams, state: NetState,
         i_ext: torch.Tensor | None = None, *, dopamine=None, packed=None,
         gen_u: torch.Tensor | None = None) -> tuple[NetState, StepOutput]:
    """One 1 ms tick; returns (state', output) and leaves ``state`` as it was.

    ``dopamine`` is the tick's scalar f32 dopamine concentration for
    DA-STDP projections (0.0 when None). Homeostasis, a slow timer between
    segments, is :func:`run`'s.

    ``gen_u`` holds this tick's uniforms for the generator spans
    (``[static.n_gen]`` f32). Without it the tick draws as the reference's
    ``step`` does: ``key, k_gen = split(state.key)`` and one uniform per
    neuron from ``k_gen``, the generators' columns of which are used.
    ``packed`` is :func:`repro_torch.core.backend.assemble_packed`'s output
    (:func:`~repro_torch.core.backend.assemble_fused`'s with
    ``backend="fused"``), assembled here when omitted.
    """
    dev = state.ring.device
    key = state.key
    gen_row = None
    if static.n_gen:
        if gen_u is None:
            key, k_gen = rng.split(state.key)
            full = rng.uniform(k_gen, (static.n,))
            gen_u = torch.cat([full[g0:g0 + sz] for g0, sz in static.gen_spans])
        _check_gen_u(gen_u, (static.n_gen,), dev)
        gen_row = _gen_spikes(static, params, state.t, gen_u[None])[0]
    fused = static.backend == "fused"
    if packed is None and static.propagation != "loop":
        packed = (be.assemble_fused(static, state.weights, params) if fused
                  else be.assemble_packed(static, state.weights))
    if static.fused_kernel and i_ext is None:
        if packed.kernel is None:
            raise ValueError("packed lacks the fused_tick kernel's payload: pass "
                             "assemble_fused(static, weights, params)")
        return _step_kernel(static, params, state._replace(key=key), packed, gen_row)
    if fused:
        packed = packed.packed
    ring = state.ring.clone()
    neurons, spikes, i_syn, cond = _neuron_phase(static, params, state.neurons, ring,
                                                 state.t, gen_row, i_ext, state.cond)
    syn = _synaptic_phase(static, params, spikes.to(f32), ring, state.t, packed,
                          _Syn(state.weights, state.stp, state.stdp), None, None, None,
                          dopamine)
    new_state = state._replace(t=state.t + 1, key=key, neurons=neurons, ring=ring,
                               cond=cond, **syn._asdict())
    return new_state, StepOutput(spikes=spikes, v=neurons.v.to(f32), i_syn=i_syn)


def _gen_full_row(static: NetStatic, gen_spk: torch.Tensor | None, rows: torch.Tensor):
    """Write generator spikes ``[(B,) T, n_gen]`` into their columns of
    ``rows`` ``[(B,) T, N]``."""
    if gen_spk is None:
        return
    off = 0
    for g0, sz in static.gen_spans:
        rows[..., g0:g0 + sz] = gen_spk[..., off:off + sz]
        off += sz


def _step_kernel(static, params, state, payload, gen_row):
    """One tick through the ``fused_tick`` kernel (``static.fused_kernel``):
    the reference's ``_step_kernel``, as a one-tick run on copies of the
    state. The refractory countdown, identically zero on the IZH4-only
    nets the kernel takes, is kept for state parity."""
    dev = state.ring.device
    rows = torch.zeros((1, static.n), dtype=torch.bool, device=dev)
    _gen_full_row(static, None if gen_row is None else gen_row[None], rows)
    i_rows = torch.empty((1, static.n), dtype=f32, device=dev)
    v, u = state.neurons.v.clone(), state.neurons.u.clone()
    ring = state.ring.clone()
    p = params.neuron
    ops.FusedTickRun(payload.kernel, v, u, ring[:, :, 0],
                     p.model == nrn.NeuronModel.GENERATOR, p.a, p.b, p.c, p.d,
                     rows, i_rows=i_rows, dt=static.dt,
                     substeps=static.substeps).tick(0, state.t)
    refrac = torch.clamp_min(state.neurons.refrac - 1, 0)
    new_state = state._replace(t=state.t + 1,
                               neurons=NeuronState(v=v, u=u, refrac=refrac), ring=ring)
    return new_state, StepOutput(spikes=rows[0], v=v.to(f32), i_syn=i_rows[0])


def _run_kernel(static, params, state, n_steps, payload, gen_spk, raster,
                record_v, record_i, mon=None, watch=None):
    """``run``'s loop on the ``fused_tick`` kernel: one operation per tick.

    The generator spikes of every tick are written into the raster before
    the loop; the kernel reads a tick's row where ``is_gen`` and writes the
    whole spike row back into it, and writes v' and i_syn rows when they
    are recorded, and folds the default monitors (``mon``, a
    :class:`_Telemetry`) and watches (``watch``, a :class:`_Watches`). The
    refractory countdown is applied once, for all ticks.
    """
    dev = state.ring.device
    rows = torch.zeros((n_steps, static.n), dtype=torch.bool, device=dev)
    _gen_full_row(static, gen_spk, rows)
    v = state.neurons.v.clone()
    u = state.neurons.u.clone()
    ring = state.ring.clone()
    vs = torch.empty((n_steps, static.n), dtype=f32, device=dev) if record_v else None
    cur = torch.empty((n_steps, static.n), dtype=f32, device=dev) if record_i else None
    p = params.neuron
    runner = ops.FusedTickRun(payload.kernel, v, u, ring[:, :, 0],
                              p.model == nrn.NeuronModel.GENERATOR, p.a, p.b, p.c,
                              p.d, rows, vs, cur, dt=static.dt,
                              substeps=static.substeps, **_kernel_slots(mon, watch))
    for i in range(n_steps):
        runner.tick(i, state.t + i)
        if mon is not None and mon.plain:
            mon.tick(i, rows[i], v, state.weights)
        if watch is not None and watch.due(i):
            watch.tick(i, rows[i], v, state.weights)
    refrac = torch.clamp_min(state.neurons.refrac - min(n_steps, _REFRAC_MAX), 0)
    final = state._replace(t=state.t + n_steps,
                           neurons=NeuronState(v=v, u=u, refrac=refrac), ring=ring)
    return final, _outputs(rows if raster else None, vs, cur)


def _kernel_slots(mon: _Telemetry | None, watch: _Watches | None = None) -> dict:
    """The neuron kernel's monitor and watch slots of a run (none without
    monitors or watches), the run told that the kernel folds them."""
    slots = {}
    for part in (mon, watch):
        if part is not None:
            part.in_kernel(True)
            slots.update(part.kernel)
    return slots


def _run_kernel_lanes(static, params, state, n_steps, gen_spk, raster, vs, cur, prop,
                      mon=None, watch=None):
    """:func:`_run_lanes` on the ``fused_tick`` kernel: one launch per tick
    for every lane (``ops.FusedTickRun`` over lanes, each lane at its own
    ring slot), on ``prop``'s kernel payload (the weights every lane
    shares, or each lane's own) or one built here on ``state.weights``."""
    lanes = len(state.t)
    dev = state.ring.device
    rows = raster if raster is not None else torch.empty(
        (lanes, n_steps, static.n), dtype=torch.bool, device=dev)
    rows.zero_()
    _gen_full_row(static, gen_spk, rows)
    payload = (prop.kernel if prop is not None and prop.kernel is not None
               else be.LanePropagation(static, params, state.weights, lanes).kernel)
    v, u, ring = state.neurons.v.clone(), state.neurons.u.clone(), state.ring.clone()
    p = params.neuron
    runner = ops.FusedTickRun(payload, v, u, ring[..., 0],
                              p.model == nrn.NeuronModel.GENERATOR, p.a, p.b, p.c, p.d, rows,
                              vs, cur, dt=static.dt, substeps=static.substeps, t0=state.t,
                              **_kernel_slots(mon, watch))
    for i in range(n_steps):
        runner.tick(i)
        if mon is not None and mon.plain:
            mon.tick(i, rows[:, i], v, state.weights)
        if watch is not None and watch.due(i):
            watch.tick(i, rows[:, i], v, state.weights)
    refrac = torch.clamp_min(state.neurons.refrac - min(n_steps, _REFRAC_MAX), 0)
    final = state._replace(t=tuple(t + n_steps for t in state.t), ring=ring,
                           neurons=NeuronState(v=v, u=u, refrac=refrac))
    return final, _outputs(raster, vs, cur)


def _check_record(static: NetStatic, record: str, return_tel_carry: bool = False) -> bool:
    """The reference's checks of ``record`` and ``return_tel_carry``;
    returns whether the run keeps its monitors."""
    if record not in _RECORD_MODES:
        raise ValueError(f"record must be one of {_RECORD_MODES}, got {record!r}")
    want_mon = record in ("monitors", "both")
    if want_mon and not static.monitors:
        raise ValueError(
            "record requests monitors but the network was compiled with "
            "monitors=() — pass monitor specs (or 'default') to compile()")
    if return_tel_carry and not want_mon:
        raise ValueError("return_tel_carry requires record='monitors'/'both'")
    return want_mon


class _Telemetry:
    """A run's in-run monitors (``static.monitors``) over ``n_steps`` ticks
    on ``device`` (over ``lanes``: a leading ``[B]`` on every slot): the
    carry (copies of ``carry``'s tensors, the caller's ``tel_carry``, else
    zeros), the VoltageProbe rows ``[(B,) T, k]`` f32, and :attr:`kernel`,
    the first SpikeCount's and GroupRate's slots as the neuron kernels take
    them (``ops.NeuronRun``, ``ops.FusedTickRun``). Once the run knows
    whether a kernel folds those two (:meth:`in_kernel`), :meth:`tick`
    folds every other monitor as plain ops
    (:func:`repro_torch.telemetry.monitors.update`); :attr:`plain` says
    whether there is any (with the default set in a kernel there is none,
    and the run's loop does not call it)."""

    def __init__(self, static: NetStatic, n_steps: int, device, carry=None,
                 lanes: int | None = None):
        self.static = static
        if carry is None:
            carry = tel.init_carry(static, n_steps, device=device, lanes=lanes)
        elif len(carry) != len(static.monitors):
            raise ValueError(f"tel_carry has {len(carry)} slots for "
                             f"{len(static.monitors)} monitors")
        else:
            carry = tuple(c.clone() if isinstance(c, torch.Tensor) else c for c in carry)
        self.carry = carry
        lead = () if lanes is None else (lanes,)
        self.rows = {k: torch.empty((*lead, n_steps, len(spec.neurons)), dtype=f32,
                                    device=device)
                     for k, spec in enumerate(static.monitors)
                     if isinstance(spec, tel.VoltageProbe)}
        count, rate = tel.kernel_slots(static)
        self.kernel = dict(
            tel_count=None if count is None else carry[count],
            tel_rate=None if rate is None else carry[rate],
            rate=(0.0, 0.0) if rate is None else tel.rate_constants(static,
                                                                   static.monitors[rate]))
        self._held = {k for k in (count, rate) if k is not None}
        self.in_kernel(False)

    def in_kernel(self, held: bool) -> None:
        """Whether the run's neuron kernel folds :attr:`kernel`'s slots."""
        self._skip = self._held if held else set()
        self.plain = len(self._skip) < len(self.static.monitors)

    def tick(self, i: int, spikes: torch.Tensor, v: torch.Tensor, weights: tuple) -> None:
        """The run's ``i``-th tick: its spike row ``[(B,) N]``, stored ``v``
        and weights after plasticity."""
        _, ys = tel.update(self.static, self.carry, i, spikes, v, weights, skip=self._skip)
        for k, rows in self.rows.items():
            rows[..., i, :] = ys[k]

    def outputs(self, outputs: dict, return_carry: bool) -> dict:
        """``outputs`` with ``"telemetry"`` (:func:`~repro_torch.telemetry.
        monitors.collect`) and, where asked, ``"tel_carry"``, the raw carry."""
        ys = tuple(self.rows.get(k) for k in range(len(self.static.monitors)))
        outputs["telemetry"] = tel.collect(self.static, self.carry, ys)
        if return_carry:
            outputs["tel_carry"] = self.carry
        return outputs


class _Watches:
    """A run's in-run watches (``static.watches``) on ``device`` (over
    ``lanes``: a leading ``[B]`` on every slot), from ``carry`` (the
    caller's ``watch_carry``: tensors, numpy values or ints in the
    reference's layout, left as they were) or fresh accumulators.

    The run keeps each RateBand's counts, each Silent's and NonFinite's
    words (:func:`repro_torch.obs.watch.kernel_words`), each NonFinite's
    weight-check count and each WeightDrift's norms on its own copies.
    :attr:`kernel` is the first RateBand's, Silent's and NonFinite's slots
    as the neuron kernels take them (``ops.NeuronRun``,
    ``ops.FusedTickRun``); once the run knows whether a kernel folds them
    (:meth:`in_kernel`), :meth:`tick` folds the others
    (:func:`repro_torch.kernels.ref.watch_fold_ref`) and, on their stride's
    ticks, the plastic weights' NonFinite check and WeightDrift's norms as
    plain ops; :meth:`due` says whether tick ``i`` has any such work (with
    the default set in a kernel and no plastic projection, none).
    :meth:`carry` gives the reference's carry after the run."""

    def __init__(self, static: NetStatic, device, carry=None, lanes: int | None = None):
        self.static = static
        self.lead = () if lanes is None else (lanes,)
        specs = static.watches
        if carry is None:
            carry = wat.init_carry(static, device=device, lanes=lanes)
        else:
            carry = _watch_carry_in(static, carry, device, self.lead)
        self.first = carry
        self.words, self.count, self.bad_w, self.norms = {}, {}, {}, {}
        for k, (s, c) in enumerate(zip(specs, carry)):
            if isinstance(s, (wat.Silent, wat.NonFinite)):
                self.words[k] = wat.kernel_words(s, c)
            if isinstance(s, wat.NonFinite):
                self.bad_w[k] = c[1].clone()
            elif isinstance(s, wat.RateBand):
                self.count[k] = c[0].clone()
            elif isinstance(s, wat.WeightDrift):
                self.norms[k] = c[0].clone()
        rate, silent, bad = wat.kernel_slots(static)
        self.kernel = dict(w_count=None if rate is None else self.count[rate],
                           w_silent=None if silent is None else self.words[silent],
                           w_bad=None if bad is None else self.words[bad])
        self._held = {k for k in (rate, silent, bad) if k is not None}
        plastic = any(cfg is not None for cfg in static.stdp)
        self._strided = [(k, s.weight_stride) for k, s in enumerate(specs)
                         if isinstance(s, wat.NonFinite) and plastic]
        self._strided += [(k, s.stride) for k, s in enumerate(specs)
                          if isinstance(s, wat.WeightDrift)]
        self.in_kernel(False)

    def in_kernel(self, held: bool) -> None:
        """Whether the run's neuron kernel folds :attr:`kernel`'s slots."""
        skip = self._held if held else set()
        self._plain = [k for k, s in enumerate(self.static.watches)
                       if k not in skip and not isinstance(s, wat.WeightDrift)]

    def due(self, i: int) -> bool:
        """Whether tick ``i`` has plain work (:meth:`tick`)."""
        return bool(self._plain) or any(i % stride == 0 for _, stride in self._strided)

    def tick(self, i: int, spikes: torch.Tensor, v: torch.Tensor, weights: tuple) -> None:
        """The run's ``i``-th tick: its spike row ``[(B,) N]``, stored ``v``
        and weights after plasticity."""
        specs = self.static.watches
        for k in self._plain:
            s = specs[k]
            if isinstance(s, wat.RateBand):
                watch_fold_ref(i, spikes, v, w_count=self.count[k])
            elif isinstance(s, wat.Silent):
                watch_fold_ref(i, spikes, v, w_silent=self.words[k])
            else:
                watch_fold_ref(i, spikes, v, w_bad=self.words[k])
        for k, stride in self._strided:
            if i % stride:
                continue
            if isinstance(specs[k], wat.NonFinite):
                self.bad_w[k] += ~wat._plastic_finite(self.static, weights, len(self.lead))
            else:
                self.norms[k] = wat._l2(weights, len(self.lead))

    def carry(self, n_steps: int) -> tuple:
        """The watch carry after the run's ``n_steps`` ticks."""
        out = []
        for k, (s, c) in enumerate(zip(self.static.watches, self.first)):
            if isinstance(s, wat.Silent):
                out.append(wat.carry_from_words(s, self.words[k], c, n_steps))
            elif isinstance(s, wat.NonFinite):
                bad_v, _ = wat.carry_from_words(s, self.words[k], c, n_steps)
                out.append((bad_v, self.bad_w[k]))
            elif isinstance(s, wat.RateBand):
                out.append((self.count[k], (c[1] + n_steps).to(torch.int32)))
            else:
                out.append((self.norms[k],))
        return tuple(out)


def _watch_carry_in(static: NetStatic, carry, device, lead: tuple) -> tuple:
    """A caller's watch carry as the run's own tensors on ``device``, in the
    shapes and dtypes of :func:`repro_torch.obs.watch.init_carry`."""
    fresh = wat.init_carry(static, device="meta", lanes=lead[0] if lead else None)
    if len(carry) != len(fresh) or any(len(c) != len(f) for c, f in zip(carry, fresh)):
        raise ValueError(f"watch_carry does not match the net's {len(fresh)} watches")
    out = []
    for c, f in zip(carry, fresh):
        slot = []
        for x, like in zip(c, f):
            x = (x if isinstance(x, torch.Tensor) else torch.tensor(x)).to(device)
            if x.shape != like.shape:
                raise ValueError(f"watch_carry slot of shape {tuple(x.shape)}, want "
                                 f"{tuple(like.shape)}")
            slot.append(x.to(like.dtype, copy=True))
        out.append(tuple(slot))
    return tuple(out)


def _with_watch(outputs: dict, watch: _Watches | None, n_steps: int) -> dict:
    if watch is not None:
        outputs["watch_carry"] = watch.carry(n_steps)
    return outputs


def _check_active(active, dev: torch.device) -> torch.Tensor:
    active = torch.as_tensor(active, device=dev)
    if active.dtype != torch.bool or active.dim() != 0:
        raise ValueError(f"active must be a 0-dim bool tensor, got {active.dtype} "
                         f"{tuple(active.shape)}")
    return active


def _gen_source(static: NetStatic, params: NetParams, t0, key: torch.Tensor, n_steps: int,
                *, gen_chunk: int | None, gen_base: torch.Tensor | None,
                active: torch.Tensor | None, gen_u: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
    """The generator set-up of :func:`run` (``t0`` the first tick, an int;
    ``key`` int32 ``[2]``; ``active`` 0-dim) and of :func:`_run_lanes`
    (``t0`` int64 ``[B]``, each lane's first tick; ``key`` ``[B, 2]``;
    ``active`` ``[B]``): checks the stream options and draws as
    :func:`run`'s docstring says, every lane's uniforms of a segment in one
    call. Returns ``(key', gen_spk, chunk)``: the key the final state
    carries, the generator spikes of the first segment (the whole run's
    ``[T, n_gen]``, or ``[B, T, n_gen]`` over lanes, unless the run draws
    per ``gen_chunk``; None without generators), and ``chunk(c)``, segment
    ``c``'s spikes where the run draws per ``gen_chunk`` (else None)."""
    if gen_chunk is not None and gen_chunk < 1:
        raise ValueError(f"gen_chunk must be >= 1, got {gen_chunk}")
    if gen_base is not None and gen_chunk is not None:
        raise ValueError("gen_base and gen_chunk are mutually exclusive: a session "
                         "stream is already bounded per call by the chunk size")
    if (gen_u is not None or generator is not None) and (
            gen_base is not None or gen_chunk is not None):
        raise ValueError("gen_u and generator supply the whole run's uniforms: they "
                         "exclude gen_base and gen_chunk")
    chunked = gen_chunk is not None and static.n_gen > 0 and gen_chunk < n_steps
    if chunked and n_steps % gen_chunk:
        raise ValueError(f"gen_chunk ({gen_chunk}) must divide n_steps ({n_steps}): "
                         "the generators draw whole chunks")
    dev = key.device
    if gen_base is not None and (gen_base.shape != key.shape or gen_base.dtype != torch.int32
                                 or gen_base.device != dev):
        raise ValueError(f"gen_base must be an int32 {list(key.shape)} key on {dev}, got "
                         f"{gen_base.dtype} {tuple(gen_base.shape)} on {gen_base.device}")
    lanes = torch.is_tensor(t0)
    seg_keys = None
    if static.n_gen:
        if gen_base is not None:
            steps = torch.arange(n_steps, dtype=torch.int64, device=dev)
            ticks = (t0[:, None] if lanes else t0) + steps
            gen_u = rng.uniform(rng.fold_in(gen_base, ticks), (static.n_gen,))
        elif gen_u is None and generator is None:
            k_draw, key = rng.split(key).unbind(-2)
            if chunked:
                seg_keys = rng.split(k_draw, n_steps // gen_chunk)
            else:
                gen_u = rng.uniform(k_draw, (n_steps, static.n_gen))
        elif gen_u is None:
            gen_u = torch.rand((n_steps, static.n_gen), generator=generator,
                               dtype=f32, device=dev)
        else:
            _check_gen_u(gen_u, (n_steps, static.n_gen), dev)
    gate = None if active is None else active[:, None, None] if lanes else active

    def segment(i0: int, u: torch.Tensor) -> torch.Tensor:
        """The generator spikes of ticks ``t0 + i0 ..`` from their uniforms ``u``."""
        if gate is not None:
            u = torch.where(gate, u, 1.0)
        return _gen_spikes(static, params, t0 + i0, u)

    def chunk(c: int) -> torch.Tensor:
        return segment(c * gen_chunk,
                       rng.uniform(seg_keys[..., c, :], (gen_chunk, static.n_gen)))

    if seg_keys is not None:
        return key, chunk(0), chunk
    return key, None if gen_u is None else segment(0, gen_u), None


def _homeo_period(static: NetStatic, n_steps: int, gen_chunk: int | None) -> int:
    """The run's homeostasis period (0 for none), after the reference's
    checks: ``n_steps`` a multiple of it, and a chunked generator draw
    (``gen_chunk``, None when the run draws whole) cut at it."""
    period = static.homeo_period if any(h is not None for h in static.homeo) else 0
    if period and n_steps % period:
        raise ValueError(
            f"n_steps ({n_steps}) must be a multiple of the homeostasis period "
            f"({period}): the slow timer fires at whole-segment boundaries")
    if gen_chunk is not None and period and gen_chunk != period:
        raise ValueError(f"gen_chunk ({gen_chunk}) must equal the homeostasis period "
                         f"({period}): both cut the run into the same segments")
    return period


def _stdp_launchers(static: NetStatic, params: NetParams, state: NetState,
                    lanes: int | None = None):
    """The run's pair-STDP launchers (``stdp_gather`` and ``stdp_update``,
    those the net has), their zero-ended dense buffers, and the state's
    weights with the launchers' buffers in their projections' places."""
    runs = tuple(x for x in (
        be.assemble_stdp_gather(static, params, state.weights, state.stdp, lanes),
        be.assemble_stdp_update(static, params, state.weights, state.stdp, lanes))
        if x is not None)
    padded, weights = {}, state.weights
    for stdp_run in runs:
        weights = stdp_run.adopt(weights)
        padded.update(getattr(stdp_run, "padded", {}))
    return runs, padded, weights


def _final_syn(syn: _Syn, stdp_runs) -> _Syn:
    """``syn`` with the traces the launchers hold in their projections'
    places."""
    stdp = list(syn.stdp)
    for stdp_run in stdp_runs:
        for k, j in enumerate(stdp_run.keys):
            stdp[j] = STDPState(*stdp_run.traces(k))
    return syn._replace(stdp=tuple(stdp))


def run(
    static: NetStatic,
    params: NetParams,
    state: NetState,
    n_steps: int,
    *,
    i_ext: torch.Tensor | None = None,
    dopamine: torch.Tensor | None = None,
    record: str = "raster",
    record_v: bool = False,
    record_i: bool = False,
    gen_u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    gen_chunk: int | None = None,
    gen_base: torch.Tensor | None = None,
    active: torch.Tensor | None = None,
    tel_carry=None,
    return_tel_carry: bool = False,
    watch_carry=None,
) -> tuple[NetState, dict]:
    """Run ``n_steps`` ticks; returns ``(state', outputs)``.

    ``record="raster"`` puts the ``[T, N]`` bool raster in
    ``outputs["spikes"]``; ``"monitors"`` keeps the net's in-run monitors
    (``static.monitors``) instead and puts their output in
    ``outputs["telemetry"]`` (:func:`repro_torch.telemetry.monitors.collect`:
    per-group SpikeCount totals and GroupRate levels as CPU tensors
    ``[G]``, VoltageProbe rows ``[T, k]`` and WeightNorm snapshots on the
    net's device); ``"both"`` does both; ``"none"`` records nothing. On a
    neuron kernel's tick (``ops.NeuronRun``, ``ops.FusedTickRun``) the
    first SpikeCount and GroupRate are folded inside its launch, so the
    default monitor set adds no device operation per tick. ``tel_carry``
    resumes the monitors' accumulators (a chunked session's carry,
    :func:`repro_torch.telemetry.monitors.chunk_carry`; the caller's
    tensors are left as they were) and ``return_tel_carry`` returns the
    final ones raw in ``outputs["tel_carry"]``. ``record_v`` /
    ``record_i`` add ``[T, N]`` f32 traces ``outputs["v"]`` /
    ``outputs["i_syn"]``. ``i_ext`` is an optional ``[T, N]`` external
    current, ``dopamine`` an optional ``[T]`` f32 dopamine schedule on the
    net's device (one concentration per tick, for DA-STDP).

    With ``static.homeo_period`` set, ``n_steps`` must be a multiple of it:
    the weights of the projections carrying homeostasis scale at the end
    of every segment of that many ticks.

    The generators draw from ``gen_u`` (``[T, n_gen]`` f32) when given.
    Otherwise run draws their uniforms as the reference's ``run`` does:

    * by default all ``[T, n_gen]`` up front, ``k_draw, k_carry =
      split(state.key)`` and ``uniform(k_draw, (T, n_gen))``; the returned
      state carries ``k_carry``, so consecutive runs draw the reference's
      streams;
    * ``gen_chunk`` (dividing ``n_steps``, and equal to the homeostasis
      period where there is one) draws ``[gen_chunk, n_gen]`` per chunk,
      chunk ``c`` from ``split(k_draw, T // gen_chunk)[c]``, so the
      generator buffers are O(gen_chunk) (a ``fused_kernel`` net's run
      still writes every tick's generator spikes into its rows up
      front); a chunk that covers the run is the whole-run draw, bit for
      bit;
    * ``gen_base`` (a key, int32 ``[2]`` as ``NetState.key``; it excludes
      ``gen_chunk``) draws tick ``t``'s ``uniform(fold_in(gen_base, t),
      (n_gen,))``, ``t`` the absolute tick, and leaves the key as it was:
      one ``run(T)`` equals ``k`` runs of ``T/k`` with the state threaded
      through, bit for bit;
    * ``generator``, a ``torch.Generator`` on the net's device, draws all
      of them with ``torch.rand`` and leaves the key as it was.

    ``active`` (a 0-dim bool tensor on the net's device, never read back
    to the host) gates a serving lane: where it is False the generators
    draw no spike (their uniforms become 1.0) and homeostasis leaves the
    rates and weights as they were.

    A net compiled with watches (``static.watches``) keeps them through
    the run whatever ``record`` is, and returns the final accumulators raw
    in ``outputs["watch_carry"]`` (the reference's layout); ``watch_carry``
    resumes them (a chunked session's carry; the caller's values are left
    as they were; ignored on a net without watches). On a neuron kernel's
    tick the first RateBand, Silent and NonFinite fold inside its launch.
    A strided check counts the run's local step ``i``, not the absolute
    tick.

    ``state`` is left as it was: the run works on its own copy of the ring.
    """
    want_mon = _check_record(static, record, return_tel_carry)
    dev = state.ring.device
    if active is not None:
        active = _check_active(active, dev)
    key, gen_spk, chunk = _gen_source(static, params, state.t, state.key, n_steps,
                                      gen_chunk=gen_chunk, gen_base=gen_base, active=active,
                                      gen_u=gen_u, generator=generator)
    if i_ext is not None and i_ext.shape != (n_steps, static.n):
        raise ValueError(f"i_ext must be [{n_steps}, {static.n}], got "
                         f"{tuple(i_ext.shape)}")
    if dopamine is not None and (dopamine.shape != (n_steps,)
                                 or dopamine.dtype != f32 or dopamine.device != dev):
        raise ValueError(f"dopamine must be float32 [{n_steps}] on {dev}, got "
                         f"{dopamine.dtype} {tuple(dopamine.shape)} on {dopamine.device}")
    period = _homeo_period(static, n_steps, gen_chunk if chunk is not None else None)

    state = state._replace(key=key)
    want_raster = record in ("raster", "both")
    mon = _Telemetry(static, n_steps, dev, tel_carry) if want_mon else None
    watch = _Watches(static, dev, watch_carry) if static.watches else None
    if static.fused_kernel and i_ext is None:
        if chunk is not None:
            gen_spk = torch.cat([gen_spk] + [chunk(c) for c in range(1, n_steps // gen_chunk)])
        final, outputs = _run_kernel(static, params, state, n_steps,
                                     be.assemble_fused(static, state.weights, params),
                                     gen_spk, want_raster, record_v, record_i, mon, watch)
        return final, _with_watch(_with_telemetry(outputs, mon, return_tel_carry), watch,
                                  n_steps)
    loop = static.propagation == "loop"
    packed = fanin = matmul = gather = None
    if not loop:
        packed = be.assemble_packed(static, state.weights)
        fanin = be.assemble_fanin(static, params)
        matmul = be.assemble_matmul(static, packed)
        gather = be.assemble_gather(static, params, packed)
    ring = state.ring.clone()
    neurons, cond = state.neurons, state.cond
    decays = None if static.coba is None else decay_factors(static.coba, static.dt)
    homeo = state.homeo
    counts = torch.zeros((static.n,), dtype=torch.int32, device=dev) if period else None
    raster = (torch.empty((n_steps, static.n), dtype=torch.bool, device=dev)
              if want_raster else None)
    vs = torch.empty((n_steps, static.n), dtype=f32, device=dev) if record_v else None
    cur = torch.empty((n_steps, static.n), dtype=f32, device=dev) if record_i else None
    slots = {**({} if mon is None else mon.kernel),
             **({} if watch is None else watch.kernel)}
    neuron_run = be.assemble_neurons(static, params, neurons, ring, cond=cond,
                                     gen_spk=gen_spk, i_ext=i_ext, raster=raster,
                                     v_rows=vs, i_rows=cur, counts=counts, tel=slots)
    for part in (mon, watch):
        if part is not None:
            part.in_kernel(neuron_run is not None)
    stdp_runs, padded, weights = _stdp_launchers(static, params, state)
    drive = None if loop else be.assemble_drive(static, params, weights, state.stp, gather,
                                                 fanin)
    syn = _Syn(weights, state.stp, state.stdp)
    seg0 = 0  # the run's tick at gen_spk's row 0
    for i in range(n_steps):
        t = state.t + i
        if chunk is not None and i and i % gen_chunk == 0:
            gen_spk, seg0 = chunk(i // gen_chunk), i
            if neuron_run is not None:
                neuron_run.rows(gen_spk, i)
        if neuron_run is not None:
            neuron_run(i, t)
            spikes_f32 = neuron_run.spikes
        else:
            neurons, spikes, i_syn, cond = _neuron_phase(
                static, params, neurons, ring, t,
                None if gen_spk is None else gen_spk[i - seg0],
                None if i_ext is None else i_ext[i], cond, decays)
            spikes_f32 = spikes.to(f32)
            if counts is not None:
                counts += spikes
            if raster is not None:
                raster[i] = spikes
            if vs is not None:
                vs[i] = neurons.v
            if cur is not None:
                cur[i] = i_syn
        syn = _synaptic_phase(static, params, spikes_f32, ring, t, packed, syn, fanin,
                              matmul, gather, None if dopamine is None else dopamine[i],
                              stdp_runs, padded, drive)
        if mon is not None and mon.plain:
            mon.tick(i, spikes_f32, neurons.v if neuron_run is None else neuron_run.v,
                     syn.weights)
        if watch is not None and watch.due(i):
            watch.tick(i, spikes_f32, neurons.v if neuron_run is None else neuron_run.v,
                       syn.weights)
        if counts is not None and (i + 1) % period == 0:
            weights, homeo = _apply_homeostasis(static, syn.weights, homeo, counts, active)
            for stdp_run in stdp_runs:
                weights = stdp_run.adopt(weights)
            syn = syn._replace(weights=weights)
            counts.zero_()
    if neuron_run is not None:
        neurons = NeuronState(v=neuron_run.v, u=neuron_run.u, refrac=neuron_run.refrac)
        cond = None if neuron_run.cond is None else ConductanceState(*neuron_run.cond)
    syn = _final_syn(syn, stdp_runs)
    final = state._replace(t=state.t + n_steps, neurons=neurons, ring=ring, cond=cond,
                           homeo=homeo, **syn._asdict())
    return final, _with_watch(_with_telemetry(_outputs(raster, vs, cur), mon,
                                              return_tel_carry), watch, n_steps)


def batched_route(static: NetStatic) -> bool:
    """Whether B lanes of a net tick together, one launch per kernel for
    every lane (:func:`run_batch`, ``serve.LaneScheduler``): an IZH4-only
    Euler net on the default or the fused backend, packed, sparse or auto,
    CUBA or COBA, with any mix of pair-STDP, DA-STDP, STP and homeostasis
    projections (a fused net whose plan takes the ``fused_tick`` kernel
    ticks every lane in one launch of it; other fused nets take the default
    tick, as :func:`run` does). The ``loop`` oracle and other neuron models
    or integrators run their lanes one after another through :func:`run`,
    each lane on its own launchers."""
    return (static.backend in (None, "fused") and static.propagation != "loop"
            and static.izh4_only and static.method == "euler")


def _run_lanes(static: NetStatic, params: NetParams, state: NetState, n_steps: int, *,
               record: str = "raster", record_v: bool = False, record_i: bool = False,
               gen_chunk: int | None = None, gen_base: torch.Tensor | None = None,
               active: torch.Tensor | None = None,
               prop: be.LanePropagation | None = None, tel_carry=None,
               return_tel_carry: bool = False, watch_carry=None) -> tuple[NetState, dict]:
    """``n_steps`` ticks of the B lanes of the batched ``state``
    (:mod:`repro_torch.core.lanes`) of a :func:`batched_route` net, one
    launch per kernel per tick for every lane; returns the batched final
    state and the outputs, each with a leading ``[B]`` axis.

    Lane b runs as :func:`run` runs it from its own one-lane state, bit for
    bit: its generators draw from its key ``state.key[b]`` (the whole-run
    draw, or ``gen_chunk``'s), or from ``gen_base[b]`` (``[B, 2]``) at its
    own ticks ``state.t[b] + i``, all lanes' uniforms of a segment in one
    call; ``active`` (``[B]`` bool) gates lanes silent (their generators,
    and their homeostasis). The lanes propagate through ``prop`` (the
    static buckets' launchers on the weights every lane shares, or a
    caller's kept across runs), else through launchers built here on each
    lane's own ``state.weights`` ``[B, ...]``. Plastic, STP, DA-STDP and
    homeostasis state is each lane's own (``[B, ...]``): the pair-STDP
    launchers (``stdp_gather``, ``stdp_update``) and the plastic drive are
    built here on the lanes' current weights, the DA-STDP, STP and
    homeostasis steps run on the lane axis with dopamine 0.0, and the slow
    timer fires every ``homeo_period`` ticks of the run on per-lane spike
    counts. A ``fused_tick`` net ticks every lane in one launch of it.
    ``record="monitors"``/``"both"`` keep every lane's monitors (``[B,
    ...]`` accumulators, resumed from ``tel_carry``; the default set
    folded in the neuron kernel's launch), their output ``[B, G]`` per
    group in ``outputs["telemetry"]``, as :func:`run` for one lane; a net's
    watches ride every lane (``[B, ...]`` accumulators, resumed from
    ``watch_carry``, the default set in the same launch), returned as
    ``outputs["watch_carry"]``.
    """
    want_mon = _check_record(static, record, return_tel_carry)
    lanes = len(state.t)
    dev = state.ring.device
    t0 = torch.tensor(state.t, dtype=torch.int64, device=dev)
    key, gen_spk, chunk = _gen_source(static, params, t0, state.key, n_steps,
                                      gen_chunk=gen_chunk, gen_base=gen_base, active=active)
    period = _homeo_period(static, n_steps, gen_chunk if chunk is not None else None)
    shape = (lanes, n_steps, static.n)
    raster = (torch.empty(shape, dtype=torch.bool, device=dev)
              if record in ("raster", "both") else None)
    mon = _Telemetry(static, n_steps, dev, tel_carry, lanes) if want_mon else None
    watch = _Watches(static, dev, watch_carry, lanes) if static.watches else None
    vs = torch.empty(shape, dtype=f32, device=dev) if record_v else None
    cur = torch.empty(shape, dtype=f32, device=dev) if record_i else None
    if static.fused_kernel:
        if chunk is not None:
            gen_spk = torch.cat([gen_spk] + [chunk(c) for c in range(1, n_steps // gen_chunk)],
                                dim=1)
        final, outputs = _run_kernel_lanes(static, params, state._replace(key=key), n_steps,
                                           gen_spk, raster, vs, cur, prop, mon, watch)
        return final, _with_watch(_with_telemetry(outputs, mon, return_tel_carry), watch,
                                  n_steps)
    if prop is None:
        prop = be.LanePropagation(static, params, state.weights, lanes)
    ring = state.ring.clone()
    counts = torch.zeros((lanes, static.n), dtype=torch.int32, device=dev) if period else None
    neuron_run = be.assemble_neurons(static, params, state.neurons, ring, cond=state.cond,
                                     gen_spk=gen_spk, raster=raster, v_rows=vs, i_rows=cur,
                                     counts=counts, t0=state.t, tel=_kernel_slots(mon, watch))
    slots = be.LaneSlots(state.t, static.ring_len, dev)
    fanin = be.assemble_fanin(static, params)
    stdp_runs, padded, weights = _stdp_launchers(static, params, state, lanes)
    drive = be.assemble_drive(static, params, weights, state.stp, prop.gather, fanin, lanes)
    syn = _Syn(weights, state.stp, state.stdp)
    homeo = state.homeo
    for i in range(n_steps):
        if chunk is not None and i and i % gen_chunk == 0:
            neuron_run.rows(chunk(i // gen_chunk), i)
        neuron_run(i)
        syn = _synaptic_phase(static, params, neuron_run.spikes, ring, i, prop.packed, syn,
                              fanin, prop.matmul, prop.gather, None, stdp_runs, padded,
                              drive, slots)
        if mon is not None and mon.plain:
            mon.tick(i, neuron_run.spikes, neuron_run.v, syn.weights)
        if watch is not None and watch.due(i):
            watch.tick(i, neuron_run.spikes, neuron_run.v, syn.weights)
        if counts is not None and (i + 1) % period == 0:
            weights, homeo = _apply_homeostasis(static, syn.weights, homeo, counts, active)
            for stdp_run in stdp_runs:
                weights = stdp_run.adopt(weights)
            syn = syn._replace(weights=weights)
            counts.zero_()
    cond = None if neuron_run.cond is None else ConductanceState(*neuron_run.cond)
    final = state._replace(
        t=tuple(t + n_steps for t in state.t), key=key, ring=ring, cond=cond, homeo=homeo,
        neurons=NeuronState(v=neuron_run.v, u=neuron_run.u, refrac=neuron_run.refrac),
        **_final_syn(syn, stdp_runs)._asdict())
    return final, _with_watch(_with_telemetry(_outputs(raster, vs, cur), mon,
                                              return_tel_carry), watch, n_steps)


def _with_telemetry(outputs: dict, mon: _Telemetry | None, return_carry: bool) -> dict:
    return outputs if mon is None else mon.outputs(outputs, return_carry)


def _outputs(raster, vs, cur) -> dict:
    outputs = {}
    if raster is not None:
        outputs["spikes"] = raster
    if vs is not None:
        outputs["v"] = vs
    if cur is not None:
        outputs["i_syn"] = cur
    return outputs


def run_batch(static: NetStatic, params: NetParams, state: NetState, n_steps: int,
              batch: int, *, record: str = "raster", record_v: bool = False,
              record_i: bool = False, gen_chunk: int | None = None) -> tuple[NetState, dict]:
    """``batch`` independent trials of ``n_steps`` ticks from ``state``.

    Trial b runs :func:`run` from ``state`` with the key ``split(state.key,
    batch)[b]``: its own generator draw (``gen_chunk`` per trial), the
    other state and the weights shared. Returns ``(final_states,
    outputs)``, both with a leading ``[batch]`` axis on every tensor
    (``outputs["spikes"]`` ``[B, T, N]``; the final state a batched state
    of :mod:`repro_torch.core.lanes`, its ``t`` a tuple of B ints).

    ``batch == 1`` is :func:`run` with a leading axis. Otherwise a
    :func:`batched_route` net runs every trial in one tick loop, one launch
    per kernel per tick for all of them: ``izh4_update``, one
    ``syn_gather`` (sparse) or one ``syn_matmul`` per dense bucket
    (packed), the static weights decoded once and shared, and, on a
    plastic or STP net, one ``plastic_drive``, ``stdp_gather`` and
    ``stdp_update`` over every trial's own plastic weights; a ``fused_tick``
    net one ``fused_tick``. Every other net runs its trials one after
    another through :func:`run` (the lane-by-lane route), which the launch
    counts show. ``record="monitors"``/``"both"`` keep every trial's
    monitors: ``outputs["telemetry"]`` holds each monitor's output with a
    leading ``[batch]`` (SpikeCount and GroupRate ``[B, G]``). A net's
    watches ride every trial; ``outputs["watch_carry"]`` holds their final
    accumulators with a leading ``[batch]``.
    """
    _check_record(static, record)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    keys = rng.split(state.key, batch)
    kw = dict(record=record, record_v=record_v, record_i=record_i, gen_chunk=gen_chunk)
    if batch > 1 and batched_route(static):
        shared = be.LanePropagation(static, params, state.weights, batch)
        return _run_lanes(static, params, broadcast_state(state, batch)._replace(key=keys),
                          n_steps, prop=shared, **kw)
    finals, outs = zip(*(run(static, params, state._replace(key=keys[b]), n_steps, **kw)
                         for b in range(batch)))
    return stack_states(finals), _stack_outputs(outs)


def _stack_outputs(outs):
    """Per-trial outputs stacked on a leading axis: dicts entry by entry,
    tuples (the watch carry) slot by slot."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack_outputs([o[k] for o in outs]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack_outputs(list(x)) for x in zip(*outs))
    return torch.stack(outs)


@dataclasses.dataclass
class Engine:
    """Convenience wrapper binding a compiled network."""

    net: CompiledNetwork

    def run(self, n_steps: int, state: NetState | None = None, **kw):
        state = state if state is not None else self.net.state0
        if self.net.partition is not None:
            return self._run_partitioned(n_steps, state, **kw)
        if not obs.enabled():
            return run(self.net.static, self.net.params, state, n_steps, **kw)
        # A host-side span around the run's enqueue: nothing on the device
        # changes and nothing synchronizes it, so results are bitwise
        # identical with obs on or off. The build probe before and after
        # classifies the dispatch as a compile or a cache hit.
        before = obs.build_count()
        with obs.span("engine_run", n_ticks=n_steps, record=str(kw.get("record", "raster"))):
            out = run(self.net.static, self.net.params, state, n_steps, **kw)
        obs.note_dispatch("engine.run", before)
        obs.inc("repro_engine_ticks_total", float(n_steps))
        return out

    def _run_partitioned(self, n_steps: int, state: NetState, record: str = "raster",
                         **kw):
        """A partitioned net (``compile(partition=...)``) runs through its
        plan's lowering. The per-core runs record the raster or nothing;
        any other keyword is a feature the partitioned path does not
        express, and raises rather than diverge from :func:`run`."""
        from repro_torch.core import partition as part

        if kw:
            raise part.PartitionError(
                "partitioned runs accept record='raster'/'none' only — "
                f"unsupported kwargs: {sorted(kw)}")
        plan = self.net.partition
        fn = (part.run_partitioned if plan.spec.lowering == "sequential"
              else part.run_partitioned_mesh)
        if not obs.enabled():
            return fn(self.net.static, plan, plan.run_params, state, n_steps, record)
        with obs.span("partition_run", lowering=plan.spec.lowering, n_cores=plan.n_cores,
                      n_ticks=n_steps, record=str(record)):
            out = fn(self.net.static, plan, plan.run_params, state, n_steps, record)
        obs.inc("repro_partition_ticks_total", float(n_steps))
        obs.inc("repro_partition_exchange_bytes_total",
                float(plan.exchange.bytes_per_tick) * n_steps)
        obs.inc("repro_engine_ticks_total", float(n_steps))
        return out

    def run_batch(self, n_steps: int, batch: int, state: NetState | None = None, **kw):
        """``batch`` independent trials; see :func:`run_batch`."""
        if self.net.partition is not None:
            from repro_torch.core.partition import PartitionError

            raise PartitionError(
                "run_batch is not supported on a partitioned network — lanes over cores "
                "would replicate every core's tables per trial; run trials through a "
                "ServePool instead")
        state = state if state is not None else self.net.state0
        if not obs.enabled():
            return run_batch(self.net.static, self.net.params, state, n_steps, batch, **kw)
        before = obs.build_count()
        with obs.span("engine_run", n_ticks=n_steps, batch=batch,
                      record=str(kw.get("record", "raster"))):
            out = run_batch(self.net.static, self.net.params, state, n_steps, batch, **kw)
        obs.note_dispatch("engine.run_batch", before)
        obs.inc("repro_engine_ticks_total", float(n_steps) * batch)
        return out

    def spike_counts(self, n_steps: int, **kw) -> torch.Tensor:
        _, out = self.run(n_steps, **kw)
        return out["spikes"].sum(dim=0)

    def run_monitored(self, n_steps: int, state: NetState | None = None,
                      **kw) -> tuple[NetState, dict]:
        """Constant-memory run: in-run monitors only (no ``[T, N]`` raster);
        returns ``(final_state, summary)``, ``summary`` the host-side
        :func:`repro_torch.telemetry.summarize` dict (exact group spike
        counts and rates, filtered rates, probe traces)."""
        final, out = self.run(n_steps, state=state, record="monitors", **kw)
        return final, tel.summarize(self.net.static, out["telemetry"], n_steps)
