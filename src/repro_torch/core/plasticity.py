"""Long-term plasticity: pair-based STDP, dopamine-modulated STDP and
homeostatic synaptic scaling (CARLsim's STDP, neuromodulation and
``setHomeostasis``).

Pair-based STDP with exponential windows keeps per-neuron pre/post traces;
DA-STDP keeps a per-synapse eligibility trace gated by a scalar dopamine
signal. Every weight-touching op exists in two storage layouts:

* dense ``[n_pre, n_post]`` rectangles (``stdp_step`` / ``da_stdp_step`` /
  ``homeostasis_step``);
* CSR fan-in rows ``[n_post, fanin]`` (``stdp_step_csr`` /
  ``da_stdp_step_csr`` / ``homeostasis_step_csr``): the per-synapse update
  ``dw[q, k] = a⁺·pre_trace[idx[q, k]]·post_sp[q] −
  a⁻·pre_sp[idx[q, k]]·post_trace[q]`` as a gather + elementwise pass.

Each synapse's update reads only its own weight, two traces and two spike
bits, and both layouts spell the same f32 expression tree per synapse:
``a·(pre_term·post_term)``, ``(w + ltp) − ltd``, clip, then
``where(mask, ·, 0.0)``, then the cast to the storage dtype. A CSR row and
its dense twin therefore stay bit-identical through any spike history.

Every constant that is a Python float in the configuration
(``math.exp(-dt/tau)``, ``1000.0/dt``, ``dt/1000.0``) is computed on the
host in double and applied as an f32 scalar, as the reference's weak-typed
constants are. A division by a configuration constant divides by a tensor
on the operand's device: PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal instead, which rounds differently. The
divisor is made with ``torch.full`` (a fill on the device, no host copy).

Lanes: every op also takes B independent lanes of one projection (a
leading ``[B]`` axis on the weights, traces, eligibilities, spikes, rates
and counts; the mask, validity rows and indices shared), as
``engine.run_batch`` and ``serve.LaneScheduler`` drive them. Each op is
element-wise per lane, so a lane is bit for bit its one-lane call.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = ["STDPConfig", "STDPState", "DASTDPState", "init_stdp_state",
           "init_da_stdp_state", "stdp_step", "stdp_step_csr", "da_stdp_step",
           "da_stdp_step_csr", "HomeostasisConfig", "homeostasis_step",
           "homeostasis_step_csr"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class STDPConfig:
    a_plus: float = 0.004
    a_minus: float = 0.0033
    tau_plus: float = 20.0  # ms
    tau_minus: float = 20.0  # ms
    w_min: float = 0.0
    w_max: float = 10.0
    # DA modulation (None -> plain STDP)
    tau_elig: float | None = None  # eligibility decay for DA-STDP


class STDPState(NamedTuple):
    pre_trace: torch.Tensor  # [n_pre] f32
    post_trace: torch.Tensor  # [n_post] f32


class DASTDPState(NamedTuple):
    pre_trace: torch.Tensor
    post_trace: torch.Tensor
    elig: torch.Tensor  # [n_pre, n_post] dense / [n_post, fanin] CSR


def init_stdp_state(n_pre: int, n_post: int) -> STDPState:
    return STDPState(pre_trace=torch.zeros((n_pre,), dtype=f32),
                     post_trace=torch.zeros((n_post,), dtype=f32))


def init_da_stdp_state(n_pre: int, n_post: int, dtype: torch.dtype = f32, *,
                       fanin: int | None = None) -> DASTDPState:
    """``fanin`` selects the CSR eligibility layout ``[n_post, fanin]``;
    ``None`` keeps the dense ``[n_pre, n_post]`` rectangle."""
    shape = (n_pre, n_post) if fanin is None else (n_post, fanin)
    return DASTDPState(pre_trace=torch.zeros((n_pre,), dtype=f32),
                       post_trace=torch.zeros((n_post,), dtype=f32),
                       elig=torch.zeros(shape, dtype=dtype))


def _trace_step(trace: torch.Tensor, spikes: torch.Tensor, tau: float,
                dt: float) -> torch.Tensor:
    return trace * math.exp(-dt / tau) + spikes.to(f32)


def _csr_deltas(cfg: STDPConfig, pre_t, post_t, idx, pre_spikes, post_spikes):
    """LTP/LTD terms on the fan-in rows, ``a · (pre_term · post_term)``
    per cell as in the dense outer products."""
    ii = idx.long()
    ltp = cfg.a_plus * (pre_t[..., ii] * post_spikes.to(f32)[..., :, None])
    ltd = cfg.a_minus * (pre_spikes.to(f32)[..., ii] * post_t[..., :, None])
    return ltp, ltd


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.outer`` over any leading (lane) axes: one product per cell."""
    return a[..., :, None] * b[..., None, :]


def _outer_deltas(cfg: STDPConfig, pre_t, post_t, pre_spikes, post_spikes):
    ltp = cfg.a_plus * _outer(pre_t, post_spikes.to(f32))
    ltd = cfg.a_minus * _outer(pre_spikes.to(f32), post_t)
    return ltp, ltd


def _traces(cfg: STDPConfig, state, pre_spikes, post_spikes, dt: float):
    return (_trace_step(state.pre_trace, pre_spikes, cfg.tau_plus, dt),
            _trace_step(state.post_trace, post_spikes, cfg.tau_minus, dt))


def _clip_mask_cast(cfg: STDPConfig, w: torch.Tensor, mask: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    w = torch.clamp(w, cfg.w_min, cfg.w_max)
    return torch.where(mask, w, 0.0).to(dtype)


def stdp_step(cfg: STDPConfig, state: STDPState, weight: torch.Tensor,
              mask: torch.Tensor, pre_spikes: torch.Tensor,
              post_spikes: torch.Tensor, dt: float = 1.0
              ) -> tuple[STDPState, torch.Tensor]:
    """One tick of pair-based STDP on a dense ``[pre, post]`` storage-dtype
    weight; returns ``(state', new_weight)``.

    LTP: a post spike after pre activity moves w by +A⁺·pre_trace; LTD: a
    pre spike after post activity by −A⁻·post_trace. Weights are clipped to
    [w_min, w_max], zeroed outside ``mask`` and stored back in their dtype.
    """
    pre_t, post_t = _traces(cfg, state, pre_spikes, post_spikes, dt)
    ltp, ltd = _outer_deltas(cfg, pre_t, post_t, pre_spikes, post_spikes)
    w = _clip_mask_cast(cfg, weight.to(f32) + ltp - ltd, mask, weight.dtype)
    return STDPState(pre_trace=pre_t, post_trace=post_t), w


def stdp_step_csr(cfg: STDPConfig, state: STDPState, weight: torch.Tensor,
                  idx: torch.Tensor, valid: torch.Tensor,
                  pre_spikes: torch.Tensor, post_spikes: torch.Tensor,
                  dt: float = 1.0) -> tuple[STDPState, torch.Tensor]:
    """Pair-based STDP on CSR fan-in rows ``[post, fanin]`` (``idx`` the
    presynaptic sources, ``valid`` False on row padding): bit-identical per
    synapse to :func:`stdp_step` at the twin dense cell."""
    pre_t, post_t = _traces(cfg, state, pre_spikes, post_spikes, dt)
    ltp, ltd = _csr_deltas(cfg, pre_t, post_t, idx, pre_spikes, post_spikes)
    w = _clip_mask_cast(cfg, weight.to(f32) + ltp - ltd, valid, weight.dtype)
    return STDPState(pre_trace=pre_t, post_trace=post_t), w


def _da_update(cfg: STDPConfig, state: DASTDPState, weight, mask, ltp, ltd,
               dopamine, dt: float):
    elig = state.elig.to(f32) * math.exp(-dt / cfg.tau_elig) + (ltp - ltd)
    w = weight.to(f32) + dopamine * elig
    return elig.to(state.elig.dtype), _clip_mask_cast(cfg, w, mask, weight.dtype)


def da_stdp_step(cfg: STDPConfig, state: DASTDPState, weight: torch.Tensor,
                 mask: torch.Tensor, pre_spikes: torch.Tensor,
                 post_spikes: torch.Tensor, dopamine, dt: float = 1.0
                 ) -> tuple[DASTDPState, torch.Tensor]:
    """Dopamine-modulated STDP: the STDP terms accumulate into an
    eligibility trace, and the weight moves by ``dopamine · elig`` (a
    scalar f32 dopamine concentration this tick)."""
    if cfg.tau_elig is None:
        raise ValueError("da_stdp_step requires tau_elig")
    pre_t, post_t = _traces(cfg, state, pre_spikes, post_spikes, dt)
    ltp, ltd = _outer_deltas(cfg, pre_t, post_t, pre_spikes, post_spikes)
    elig, w = _da_update(cfg, state, weight, mask, ltp, ltd, dopamine, dt)
    return DASTDPState(pre_trace=pre_t, post_trace=post_t, elig=elig), w


def da_stdp_step_csr(cfg: STDPConfig, state: DASTDPState, weight: torch.Tensor,
                     idx: torch.Tensor, valid: torch.Tensor,
                     pre_spikes: torch.Tensor, post_spikes: torch.Tensor,
                     dopamine, dt: float = 1.0
                     ) -> tuple[DASTDPState, torch.Tensor]:
    """DA-STDP on CSR fan-in rows, the eligibility on the rows too
    (``[post, fanin]``); synapse cells evolve bit-identically to
    :func:`da_stdp_step`, padded cells are zeroed by ``valid``."""
    if cfg.tau_elig is None:
        raise ValueError("da_stdp_step_csr requires tau_elig")
    pre_t, post_t = _traces(cfg, state, pre_spikes, post_spikes, dt)
    ltp, ltd = _csr_deltas(cfg, pre_t, post_t, idx, pre_spikes, post_spikes)
    elig, w = _da_update(cfg, state, weight, valid, ltp, ltd, dopamine, dt)
    return DASTDPState(pre_trace=pre_t, post_trace=post_t, elig=elig), w


# -- homeostatic synaptic scaling (CARLsim setHomeostasis) ---------------------
#
# The engine applies these ops on CARLsim's slow timer, at every
# ``compile(homeostasis_period=p)`` boundary (``engine._apply_homeostasis``),
# with ``post_spikes`` the segment's per-neuron spike counts and ``dt`` the
# segment length in ms: ``counts · 1000/dt`` is then the segment's mean rate
# in Hz and the decay one ``exp(-segment/tau)`` step. The ops work unchanged
# per tick (bool spikes, dt = one tick).


@dataclasses.dataclass(frozen=True)
class HomeostasisConfig:
    """Multiplicative synaptic scaling toward a target firing rate; attach
    per connection (``NetworkBuilder.connect(homeostasis=...)``) together
    with ``compile(homeostasis_period=...)``."""

    target_hz: float = 10.0
    tau_avg_ms: float = 10_000.0  # firing-rate averaging window
    beta: float = 0.1  # scaling strength per second


def _homeostasis_scale(cfg: HomeostasisConfig, avg_rate, post_spikes, dt: float):
    """(new average rate, per-post scale), shared by both layouts. The
    scale is clamped to [0.5, 1.5], so a large rate error can neither flip
    the weights' sign nor blow them up."""
    decay = math.exp(-dt / cfg.tau_avg_ms)
    inst = post_spikes.to(f32) * (1000.0 / dt)  # Hz
    new_avg = avg_rate * decay + inst * (1.0 - decay)
    target = torch.full((), max(cfg.target_hz, 1e-6), dtype=f32,
                        device=avg_rate.device)
    err = (cfg.target_hz - new_avg) / target
    scale = torch.clamp(1.0 + cfg.beta * err * (dt / 1000.0), 0.5, 1.5)
    return new_avg, scale


def homeostasis_step(cfg: HomeostasisConfig, avg_rate: torch.Tensor,
                     weight: torch.Tensor, post_spikes: torch.Tensor,
                     dt: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (new avg_rate, scaled ``[pre, post]`` weight): the incoming
    weights of a neuron firing above target shrink, below target grow."""
    new_avg, scale = _homeostasis_scale(cfg, avg_rate, post_spikes, dt)
    return new_avg, (weight.to(f32) * scale[..., None, :]).to(weight.dtype)


def homeostasis_step_csr(cfg: HomeostasisConfig, avg_rate: torch.Tensor,
                         weight: torch.Tensor, post_spikes: torch.Tensor,
                         dt: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Homeostatic scaling on CSR fan-in rows ``[post, fanin]``: a dense
    column is a CSR row, so the per-post scale broadcasts over the fan-in
    axis; padding stays exactly 0."""
    new_avg, scale = _homeostasis_scale(cfg, avg_rate, post_spikes, dt)
    return new_avg, (weight.to(f32) * scale[..., :, None]).to(weight.dtype)
