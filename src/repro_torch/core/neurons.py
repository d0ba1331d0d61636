"""Spiking neuron models: Izhikevich 4/9-parameter, LIF; Euler and RK4.

CARLsim's "full feature set" that the paper ports to the MCU includes the
IZH4 model (eqs. 1-3 of the paper), the 9-parameter Izhikevich model, LIF,
and both forward-Euler and Runge-Kutta integration. All models run over
per-neuron parameter tensors, so heterogeneous networks (RS + FS +
generators in Synfire4) advance as one update.

State is held in the policy's *storage* dtype (fp16 under the paper's
policy); all math runs in f32, the softfp promotion.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

__all__ = [
    "NeuronModel",
    "NeuronParams",
    "NeuronState",
    "izh4",
    "izh9",
    "lif",
    "generator",
    "concat_params",
    "init_neuron_state",
    "update_neurons",
]

f32 = torch.float32


class NeuronModel(enum.IntEnum):
    GENERATOR = 0  # spike generator (Poisson): no membrane dynamics
    IZH4 = 1
    IZH9 = 2
    LIF = 3


class NeuronParams(NamedTuple):
    """Per-neuron parameter tensors, all shape [N] f32 except ``model``
    (int8 :class:`NeuronModel` codes)."""

    model: torch.Tensor
    # Izhikevich (IZH4 uses a,b,c,d; IZH9 additionally C,k,vr,vt,vpeak)
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    d: torch.Tensor
    C: torch.Tensor
    k: torch.Tensor
    vr: torch.Tensor
    vt: torch.Tensor
    vpeak: torch.Tensor
    # LIF
    lif_tau: torch.Tensor
    lif_vth: torch.Tensor
    lif_vreset: torch.Tensor
    lif_vrest: torch.Tensor
    lif_r: torch.Tensor
    lif_tref: torch.Tensor


class NeuronState(NamedTuple):
    v: torch.Tensor  # [N] membrane potential (storage dtype)
    u: torch.Tensor  # [N] recovery variable (storage dtype)
    refrac: torch.Tensor  # [N] int16 refractory countdown (LIF)


# -- per-group parameter factories -------------------------------------------


def _full(n: int, val: float) -> torch.Tensor:
    return torch.full((n,), val, dtype=f32)


def _defaults(n: int) -> dict:
    return dict(
        a=_full(n, 0.02), b=_full(n, 0.2), c=_full(n, -65.0), d=_full(n, 8.0),
        C=_full(n, 100.0), k=_full(n, 0.7), vr=_full(n, -60.0),
        vt=_full(n, -40.0), vpeak=_full(n, 30.0),
        lif_tau=_full(n, 10.0), lif_vth=_full(n, -50.0),
        lif_vreset=_full(n, -65.0), lif_vrest=_full(n, -65.0),
        lif_r=_full(n, 1.0), lif_tref=_full(n, 2.0),
    )


def _codes(n: int, model: NeuronModel) -> torch.Tensor:
    return torch.full((n,), int(model), dtype=torch.int8)


def izh4(n: int, a: float, b: float, c: float, d: float) -> NeuronParams:
    """IZH4 (paper eqs. 1-3): v' = 0.04v² + 5v + 140 − u + I; u' = a(bv − u)."""
    p = _defaults(n)
    p.update(a=_full(n, a), b=_full(n, b), c=_full(n, c), d=_full(n, d))
    return NeuronParams(model=_codes(n, NeuronModel.IZH4), **p)


def izh9(n: int, C: float, k: float, vr: float, vt: float, vpeak: float,
         a: float, b: float, c: float, d: float) -> NeuronParams:
    """9-parameter Izhikevich: C v' = k(v−vr)(v−vt) − u + I."""
    p = _defaults(n)
    p.update(a=_full(n, a), b=_full(n, b), c=_full(n, c), d=_full(n, d),
             C=_full(n, C), k=_full(n, k), vr=_full(n, vr), vt=_full(n, vt),
             vpeak=_full(n, vpeak))
    return NeuronParams(model=_codes(n, NeuronModel.IZH9), **p)


def lif(n: int, tau: float = 10.0, vth: float = -50.0, vreset: float = -65.0,
        vrest: float = -65.0, r: float = 1.0, tref: float = 2.0) -> NeuronParams:
    p = _defaults(n)
    p.update(lif_tau=_full(n, tau), lif_vth=_full(n, vth),
             lif_vreset=_full(n, vreset), lif_vrest=_full(n, vrest),
             lif_r=_full(n, r), lif_tref=_full(n, tref))
    return NeuronParams(model=_codes(n, NeuronModel.LIF), **p)


def generator(n: int) -> NeuronParams:
    return NeuronParams(model=_codes(n, NeuronModel.GENERATOR), **_defaults(n))


def concat_params(parts: list[NeuronParams]) -> NeuronParams:
    return NeuronParams(*[torch.cat(f) for f in zip(*parts)])


# -- dynamics ------------------------------------------------------------------


def _derivs(p: NeuronParams, v, u, i_syn):
    """Coupled (dv/dt, du/dt) for all three dynamical models, selected per
    neuron; the term order is the reference's, so each model rounds as it
    does there."""
    dv4 = 0.04 * v * v + 5.0 * v + 140.0 - u + i_syn
    du4 = p.a * (p.b * v - u)
    dv9 = (p.k * (v - p.vr) * (v - p.vt) - u + i_syn) / p.C
    du9 = p.a * (p.b * (v - p.vr) - u)
    dvl = (-(v - p.lif_vrest) + p.lif_r * i_syn) / p.lif_tau
    dul = torch.zeros_like(u)
    is9 = p.model == NeuronModel.IZH9
    isl = p.model == NeuronModel.LIF
    dv = torch.where(isl, dvl, torch.where(is9, dv9, dv4))
    du = torch.where(isl, dul, torch.where(is9, du9, du4))
    return dv, du


def update_neurons(
    p: NeuronParams,
    state: NeuronState,
    i_syn: torch.Tensor,
    *,
    dt: float = 1.0,
    substeps: int = 2,
    method: str = "euler",
    state_dtype: torch.dtype = f32,
) -> tuple[NeuronState, torch.Tensor]:
    """Advance all neurons one tick of ``dt`` ms; returns (state', spiked).

    ``substeps`` Euler half-steps per tick reproduce CARLsim's default
    integration (2 × 0.5 ms); ``method='rk4'`` is the Runge-Kutta path.
    Math in f32, state stored back in ``state_dtype``.
    """
    v = state.v.to(f32)
    u = state.u.to(f32)
    i_syn = i_syn.to(f32)
    h = dt / substeps

    if method == "euler":
        for _ in range(substeps):
            dv, du = _derivs(p, v, u, i_syn)
            v = v + h * dv
            u = u + h * du
    elif method == "rk4":
        for _ in range(substeps):
            k1v, k1u = _derivs(p, v, u, i_syn)
            k2v, k2u = _derivs(p, v + 0.5 * h * k1v, u + 0.5 * h * k1u, i_syn)
            k3v, k3u = _derivs(p, v + 0.5 * h * k2v, u + 0.5 * h * k2u, i_syn)
            k4v, k4u = _derivs(p, v + h * k3v, u + h * k3u, i_syn)
            v = v + (h / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v)
            u = u + (h / 6.0) * (k1u + 2 * k2u + 2 * k3u + k4u)
    else:
        raise ValueError(f"unknown integration method {method!r}")

    is_izh9 = p.model == NeuronModel.IZH9
    is_lif = p.model == NeuronModel.LIF
    is_gen = p.model == NeuronModel.GENERATOR

    thresh = torch.where(is_lif, p.lif_vth,
                         torch.where(is_izh9, p.vpeak, torch.full_like(v, 30.0)))
    in_refrac = state.refrac > 0
    spiked = (v >= thresh) & ~is_gen & ~in_refrac

    # Reset rules (paper eq. 3): v ← c, u ← u + d for Izhikevich; LIF resets
    # to vreset and enters refractory.
    reset_v = torch.where(is_lif, p.lif_vreset, p.c)
    v = torch.where(spiked, reset_v, v)
    u = torch.where(spiked & ~is_lif, u + p.d, u)
    v = torch.where(is_lif & in_refrac, p.lif_vreset, v)
    refrac = torch.where(
        spiked & is_lif,
        (p.lif_tref / dt).to(torch.int16),
        torch.clamp_min(state.refrac - 1, 0).to(torch.int16),
    )
    # Generators hold resting potential.
    v = torch.where(is_gen, p.c, v)
    u = torch.where(is_gen, torch.zeros_like(u), u)
    return NeuronState(v=v.to(state_dtype), u=u.to(state_dtype),
                       refrac=refrac), spiked


def init_neuron_state(p: NeuronParams, state_dtype: torch.dtype = f32) -> NeuronState:
    """Rest state: v = c (vr for IZH9, vrest for LIF), u = b·v."""
    is9 = p.model == NeuronModel.IZH9
    isl = p.model == NeuronModel.LIF
    v0 = torch.where(isl, p.lif_vrest, torch.where(is9, p.vr, p.c))
    zero = torch.zeros_like(v0)
    u0 = torch.where(isl, zero, torch.where(is9, zero, p.b * v0))
    n = p.model.shape[0]
    return NeuronState(v=v0.to(state_dtype), u=u0.to(state_dtype),
                       refrac=torch.zeros((n,), dtype=torch.int16,
                                          device=p.model.device))
