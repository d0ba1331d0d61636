"""Post-hoc spike analysis — the raster-side shim over the telemetry layer.

The reference's ``repro.core.monitors``, on numpy as there. Operates on
the [T, N] boolean rasters produced by ``engine.run`` with
``record="raster"`` (a torch tensor on any device, or a numpy array).
This module is the *post-hoc* counterpart of the in-run monitors
(``repro_torch.telemetry``): group rates are computed through the same
:func:`repro_torch.telemetry.metrics.rate_from_count` expression the
in-run ``SpikeCount`` monitor uses, so for the same run the two paths
agree bit-for-bit — long constant-memory runs should prefer
``Engine.run(n, record="monitors")`` + ``telemetry.summarize`` and never
materialize the raster at all.

The ISI and synchrony statistics only exist post hoc (they need the full
spike-time history) and are vectorized: no per-neuron Python loops, no
``np.apply_along_axis``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.network import NetStatic
from repro_torch.telemetry.metrics import rate_from_count

__all__ = ["group_rates", "isi_stats", "synchrony_index", "population_summary"]


def _host(raster) -> np.ndarray:
    """A raster as a host numpy array (a torch tensor is copied off its device)."""
    if isinstance(raster, torch.Tensor):
        return raster.detach().cpu().numpy()
    return np.asarray(raster)


def group_rates(static: NetStatic, raster: np.ndarray, dt_ms: float = 1.0) -> dict:
    """Mean firing rate (Hz) per group over the raster window.

    Bit-for-bit equal to the streaming ``SpikeCount`` monitor's rates for
    the same run: both reduce to an exact integer count and share
    ``rate_from_count``.
    """
    raster = _host(raster)
    out = {}
    for g in static.groups:
        sl = slice(g.start, g.start + g.size)
        out[g.name] = rate_from_count(raster[:, sl].sum(), g.size,
                                      raster.shape[0], dt_ms)
    return out


def isi_stats(raster: np.ndarray, dt_ms: float = 1.0) -> dict:
    """Inter-spike-interval mean/CV pooled over neurons (CV≈1 = Poisson-like,
    CV≈0 = clockwork — synfire volleys sit in between).

    Vectorized: transposing before ``nonzero`` yields spike coordinates
    grouped by neuron (time-ascending within each), so all per-neuron ISIs
    are one global ``diff`` masked to same-neuron pairs — same values in
    the same pooled order as the per-neuron loop, in O(total spikes).
    """
    raster = _host(raster)
    n_idx, t_idx = np.nonzero(raster.T)
    if t_idx.size >= 2:
        dt_all = np.diff(t_idx)
        isis = dt_all[np.diff(n_idx) == 0] * dt_ms
    else:
        isis = np.empty((0,), dtype=np.float64)
    if isis.size == 0:
        return {"mean_ms": float("nan"), "cv": float("nan"), "n": 0}
    mean = float(isis.mean())
    cv = float(isis.std() / mean) if mean > 0 else float("nan")
    return {"mean_ms": mean, "cv": cv, "n": int(len(isis))}


def synchrony_index(raster: np.ndarray, window: int = 5) -> float:
    """Golomb–Rinzel-style synchrony: variance of the population rate over
    mean single-neuron variance, smoothed over ``window`` ticks. 0 = async,
    → 1 = perfectly synchronized volleys (synfire waves score high).

    The smoothing is one vectorized sliding-window mean over the time axis
    (f64 accumulation, like the old per-column ``np.convolve``) instead of
    an O(N) Python loop via ``np.apply_along_axis``.
    """
    raster = _host(raster).astype(np.float32)
    if raster.shape[0] < window * 2:
        return float("nan")
    windows = np.lib.stride_tricks.sliding_window_view(raster, window, axis=0)
    smooth = windows.mean(axis=-1, dtype=np.float64)  # [T - window + 1, N]
    pop = smooth.mean(axis=1)
    var_pop = pop.var()
    var_ind = smooth.var(axis=0).mean()
    return float(var_pop / var_ind) if var_ind > 0 else 0.0


def population_summary(static: NetStatic, raster: np.ndarray,
                       dt_ms: float = 1.0) -> dict:
    raster = _host(raster)
    return {
        "total_spikes": int(raster.sum()),
        "mean_rate_hz": float(raster.mean() * 1000.0 / dt_ms),
        "rates": group_rates(static, raster, dt_ms),
        "isi": isi_stats(raster, dt_ms),
        "synchrony": synchrony_index(raster),
    }
