"""Conductance-based (COBA) synapses: CARLsim's ``setConductances(true)``.

Four receptor channels with exponential decay; excitatory deliveries split
AMPA/NMDA, inhibitory ones GABAa/GABAb. The current follows CARLsim's
formulation, with the NMDA voltage dependence ((v+80)/60)² / (1 +
((v+80)/60)²).

Rounding follows the reference evaluated op by op:

* the four decay factors are ``exp(-dt/τ)`` of the f32 value of
  ``-dt/τ``, computed by f32 ``exp`` (:func:`decay_factors`), as
  ``jnp.exp`` of a Python float computes them; a double-precision exp
  rounded to f32 differs by an ulp for some τ;
* a scalar such as ``1 − nmda_frac`` enters as the f32 value of the
  Python double, as the reference's weak-typed scalars do;
* a division by a constant divides by a tensor on the operand's device:
  PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
  which rounds differently.

The decayed and delivered conductances are stored in the storage dtype;
the current reads those rounded values and the membrane potential from
before the tick's update.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["COBAConfig", "ConductanceState", "init_conductance_state", "decay_factors",
           "decay_and_deliver", "coba_current"]

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class COBAConfig:
    tau_ampa: float = 5.0
    tau_nmda: float = 150.0
    tau_gabaa: float = 6.0
    tau_gabab: float = 150.0
    # Delivery split between fast and slow channels.
    nmda_frac: float = 0.1
    gabab_frac: float = 0.1
    # Reversal potentials (mV).
    e_exc: float = 0.0
    e_gabaa: float = -70.0
    e_gabab: float = -90.0


class ConductanceState(NamedTuple):
    g_ampa: torch.Tensor  # [N] storage dtype
    g_nmda: torch.Tensor
    g_gabaa: torch.Tensor
    g_gabab: torch.Tensor


def init_conductance_state(n: int, dtype: torch.dtype = f32) -> ConductanceState:
    z = torch.zeros((n,), dtype=dtype)
    return ConductanceState(z, z.clone(), z.clone(), z.clone())


def decay_factors(cfg: COBAConfig, dt: float) -> tuple[float, float, float, float]:
    """The AMPA, NMDA, GABAa and GABAb decay factors per tick: f32 ``exp``
    of the f32 scalar ``-dt/τ``, on the host, returned as the Python floats
    of those f32 values."""
    taus = (cfg.tau_ampa, cfg.tau_nmda, cfg.tau_gabaa, cfg.tau_gabab)
    x = torch.tensor([-dt / tau for tau in taus], dtype=f32)
    return tuple(float(e) for e in torch.exp(x))


def decay_and_deliver(cfg: COBAConfig, state: ConductanceState, exc_in: torch.Tensor,
                      inh_in: torch.Tensor, dt: float,
                      decays: tuple[float, ...] | None = None) -> ConductanceState:
    """Each conductance decays, ``g·decay``, then takes its share of the
    tick's delivery, ``+ frac·in`` (``exc_in``, ``inh_in`` ``[N]`` f32
    magnitudes), and is stored back in its dtype. ``decays`` is
    :func:`decay_factors`' output, computed here when omitted."""
    d_a, d_n, d_ga, d_gb = decays if decays is not None else decay_factors(cfg, dt)
    ga = state.g_ampa.to(f32) * d_a
    gn = state.g_nmda.to(f32) * d_n
    g_a = state.g_gabaa.to(f32) * d_ga
    g_b = state.g_gabab.to(f32) * d_gb
    ga = ga + (1.0 - cfg.nmda_frac) * exc_in
    gn = gn + cfg.nmda_frac * exc_in
    g_a = g_a + (1.0 - cfg.gabab_frac) * inh_in
    g_b = g_b + cfg.gabab_frac * inh_in
    sdt = state.g_ampa.dtype
    return ConductanceState(ga.to(sdt), gn.to(sdt), g_a.to(sdt), g_b.to(sdt))


def coba_current(cfg: COBAConfig, state: ConductanceState, v: torch.Tensor) -> torch.Tensor:
    """The total synaptic current (``[N]`` f32) at membrane potential ``v``:
    ``-(g_ampa·(v − e_exc) + g_nmda·gate·(v − e_exc) + g_gabaa·(v − e_gabaa)
    + g_gabab·(v − e_gabab))``, summed left to right, with ``nv = (v +
    80)/60`` and ``gate = nv·nv/(1 + nv·nv)``."""
    v = v.to(f32)
    nv = (v + 80.0) / torch.full((), 60.0, dtype=f32, device=v.device)
    gate = nv * nv / (1.0 + nv * nv)
    return -(state.g_ampa.to(f32) * (v - cfg.e_exc)
             + state.g_nmda.to(f32) * gate * (v - cfg.e_exc)
             + state.g_gabaa.to(f32) * (v - cfg.e_gabaa)
             + state.g_gabab.to(f32) * (v - cfg.e_gabab))
