"""Simulation engine: the 1 ms tick and the run loop.

Order of operations per tick follows CARLsim's kernel, as the reference's
``step`` does:

  1. read the delay-ring slot for tick t (the currents that arrive now)
     and zero it
  2. CUBA: the current is the signed slot (+ optional external current)
  3. integrate the neurons, detect and reset spikes (``izh4_update``)
  4. merge the Poisson generators' spikes
  5. propagate the spikes through every bucket into slot (t + d) mod D
     (``syn_matmul`` / ``syn_gather``), one ring commit per delay

``run`` is a Python loop over ticks. The tick index is a Python int, the
raster is written into a preallocated ``[T, N]`` bool tensor on the
device, and nothing in the loop reads a tensor back to the host, so on
the card the loop only enqueues work. The generator spikes of the whole
run are computed before the loop in one comparison (they depend only on
the uniforms and the tick), and the bucket weight payloads are decoded
once per run.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import backend as be
from repro_torch.core.network import CompiledNetwork, NetParams, NetState, NetStatic
from repro_torch.core.neurons import NeuronState

__all__ = ["StepOutput", "step", "run", "Engine"]

f32 = torch.float32

_RECORD_MODES = ("raster", "none")

# Knuth's MMIX LCG: advances the int64 run key, as the reference's
# split(key) hands the next run a fresh key.
_LCG_A, _LCG_C, _KEY_MASK = 6364136223846793005, 1442695040888963407, (1 << 63) - 1


class StepOutput(NamedTuple):
    spikes: torch.Tensor  # [N] bool
    v: torch.Tensor  # [N] f32 membrane potential after update
    i_syn: torch.Tensor  # [N] f32 synaptic current delivered this tick


def _gen_spikes(static: NetStatic, params: NetParams, t0: int,
                gen_u: torch.Tensor) -> torch.Tensor:
    """Generator spikes ``[T, n_gen]`` for ticks ``t0 .. t0+T-1``: generator
    g fires at tick t when ``gen_u[t, g] < rate * (dt / 1000)``, where the
    rate is the pulse rate while ``t_ms < until`` and the sustained rate
    after, ``t_ms`` being the tick in f32 times dt. The same f32 compare
    as the reference's per-tick merge, for all ticks at once."""
    dev = gen_u.device
    cols = torch.cat([torch.arange(g0, g0 + sz, device=dev)
                      for g0, sz in static.gen_spans])
    ticks = torch.arange(t0, t0 + gen_u.shape[0], dtype=torch.int32, device=dev)
    t_ms = (ticks.to(f32) * static.dt)[:, None]
    rate = torch.where(t_ms < params.gen_until[cols], params.gen_rate[cols],
                       params.gen_rate_after[cols])
    return gen_u < rate * (static.dt / 1000.0)


def _tick(static: NetStatic, params: NetParams, neurons: NeuronState,
          ring: torch.Tensor, t: int, packed, gen_row: torch.Tensor | None,
          i_ext_row: torch.Tensor | None):
    """One tick, updating ``ring`` in place; returns (neurons', spikes, i_syn)."""
    slot = t % static.ring_len
    i_syn = ring[slot, :, 0].to(f32, copy=True)
    ring[slot].zero_()
    if i_ext_row is not None:
        i_syn = i_syn + i_ext_row.to(f32)
    neurons, spikes = be.update_neurons_dispatch(static, params, neurons, i_syn)
    if gen_row is not None:
        off = 0
        for g0, sz in static.gen_spans:
            spikes[g0:g0 + sz] = gen_row[off:off + sz]
            off += sz
    be.propagate_packed(static, params, spikes, ring, t, packed)
    return neurons, spikes, i_syn


def _check_gen_u(gen_u: torch.Tensor, shape, device) -> None:
    if gen_u.shape != shape or gen_u.dtype != f32 or gen_u.device != device:
        raise ValueError(
            f"gen_u must be float32 {tuple(shape)} on {device}, got "
            f"{gen_u.dtype} {tuple(gen_u.shape)} on {gen_u.device}")


def step(static: NetStatic, params: NetParams, state: NetState,
         i_ext: torch.Tensor | None = None, *, packed=None,
         gen_u: torch.Tensor | None = None) -> tuple[NetState, StepOutput]:
    """One 1 ms tick; returns (state', output) and leaves ``state`` as it was.

    ``gen_u`` holds this tick's uniforms for the generator spans
    (``[static.n_gen]`` f32), required when the network has generators.
    ``packed`` is :func:`repro_torch.core.backend.assemble_packed`'s
    output, assembled here when omitted.
    """
    dev = state.ring.device
    gen_row = None
    if static.n_gen:
        if gen_u is None:
            raise ValueError(
                "step needs gen_u, this tick's generator uniforms; the "
                "reference's per-tick key draw is ROADMAP A4")
        _check_gen_u(gen_u, (static.n_gen,), dev)
        gen_row = _gen_spikes(static, params, state.t, gen_u[None])[0]
    if packed is None:
        packed = be.assemble_packed(static, state.weights)
    ring = state.ring.clone()
    neurons, spikes, i_syn = _tick(static, params, state.neurons, ring,
                                   state.t, packed, gen_row, i_ext)
    new_state = state._replace(t=state.t + 1, neurons=neurons, ring=ring)
    return new_state, StepOutput(spikes=spikes, v=neurons.v.to(f32), i_syn=i_syn)


def run(
    static: NetStatic,
    params: NetParams,
    state: NetState,
    n_steps: int,
    *,
    i_ext: torch.Tensor | None = None,
    record: str = "raster",
    record_v: bool = False,
    record_i: bool = False,
    gen_u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[NetState, dict]:
    """Run ``n_steps`` ticks; returns ``(state', outputs)``.

    ``record="raster"`` puts the ``[T, N]`` bool raster in
    ``outputs["spikes"]``; ``"none"`` records nothing. ``record_v`` /
    ``record_i`` add ``[T, N]`` f32 traces ``outputs["v"]`` /
    ``outputs["i_syn"]``. ``i_ext`` is an optional ``[T, N]`` external
    current.

    The generators draw from ``gen_u`` (``[T, n_gen]`` f32) when given:
    the parity tests inject the reference's uniforms there. Otherwise run
    draws all ``[T, n_gen]`` uniforms up front from ``generator``, a
    ``torch.Generator`` on the net's device; without one it seeds a fresh
    generator from ``state.key`` and advances the key in the returned
    state, so consecutive runs draw different streams. The streams are
    torch's, not the reference's threefry (ROADMAP A4).

    ``state`` is left as it was: the run works on its own copy of the ring.
    """
    if record not in _RECORD_MODES:
        if record in ("monitors", "both"):
            raise NotImplementedError(
                f"record={record!r} (in-run monitors) is not ported to "
                "repro_torch yet (ROADMAP A6)")
        raise ValueError(f"record must be one of {_RECORD_MODES}, got {record!r}")
    dev = state.ring.device
    key = state.key
    gen_spk = None
    if static.n_gen:
        if gen_u is None:
            if generator is None:
                seed = int(key)
                generator = torch.Generator(device=dev)
                generator.manual_seed(seed)
                key = torch.tensor((seed * _LCG_A + _LCG_C) & _KEY_MASK,
                                   dtype=torch.int64, device=dev)
            gen_u = torch.rand((n_steps, static.n_gen), generator=generator,
                               dtype=f32, device=dev)
        _check_gen_u(gen_u, (n_steps, static.n_gen), dev)
        gen_spk = _gen_spikes(static, params, state.t, gen_u)
    if i_ext is not None and i_ext.shape != (n_steps, static.n):
        raise ValueError(f"i_ext must be [{n_steps}, {static.n}], got "
                         f"{tuple(i_ext.shape)}")

    packed = be.assemble_packed(static, state.weights)
    ring = state.ring.clone()
    neurons = state.neurons
    raster = (torch.empty((n_steps, static.n), dtype=torch.bool, device=dev)
              if record == "raster" else None)
    vs = torch.empty((n_steps, static.n), dtype=f32, device=dev) if record_v else None
    cur = torch.empty((n_steps, static.n), dtype=f32, device=dev) if record_i else None
    for i in range(n_steps):
        neurons, spikes, i_syn = _tick(
            static, params, neurons, ring, state.t + i, packed,
            None if gen_spk is None else gen_spk[i],
            None if i_ext is None else i_ext[i])
        if raster is not None:
            raster[i] = spikes
        if vs is not None:
            vs[i] = neurons.v
        if cur is not None:
            cur[i] = i_syn
    final = state._replace(t=state.t + n_steps, key=key, neurons=neurons,
                           ring=ring)
    outputs = {}
    if raster is not None:
        outputs["spikes"] = raster
    if vs is not None:
        outputs["v"] = vs
    if cur is not None:
        outputs["i_syn"] = cur
    return final, outputs


@dataclasses.dataclass
class Engine:
    """Convenience wrapper binding a compiled network."""

    net: CompiledNetwork

    def run(self, n_steps: int, state: NetState | None = None, **kw):
        state = state if state is not None else self.net.state0
        return run(self.net.static, self.net.params, state, n_steps, **kw)

    def spike_counts(self, n_steps: int, **kw) -> torch.Tensor:
        _, out = self.run(n_steps, **kw)
        return out["spikes"].sum(dim=0)
