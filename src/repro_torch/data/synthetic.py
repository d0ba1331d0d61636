"""Deterministic synthetic data pipelines (tokens + spike trains).

The reference's ``repro/data/synthetic.py`` on the port's threefry
(:mod:`repro_torch.core.rng`): a token batch is a pure function of (seed,
step) through ``fold_in``, so a restart sees the same batches and every
host can make its own rows. A Zipf-ish marginal over the vocab makes CE
losses behave like text rather than uniform noise.

The Zipf rank is ``floor(u ** (-1 / (alpha - 1))) - 1``. The reference's
power is XLA CPU's f32 ``power``, which calls the C library's ``powf``;
``torch.pow`` differs from it in about 1.8 % of f32 results and f64
``pow`` rounded to f32 in about 0.06 %, which moves a token now and then.
So the power is taken by the same ``powf``, on the host
(:func:`xla_powf`): tokens equal the reference's bit for bit, on every
device.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import rng

__all__ = ["TokenStream", "spike_train", "xla_powf"]

@functools.cache
def _powf():
    """The C library's ``powf`` as a numpy ufunc (of Python floats)."""
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.powf.restype = ctypes.c_float
    lib.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return np.frompyfunc(lib.powf, 2, 1)


def xla_powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """``x ** y`` for a float32 tensor ``x`` as XLA CPU computes it: the C
    library's ``powf`` of each entry (with ``y`` rounded to float32), on
    the host; the result lies on ``x``'s device."""
    arr = x.detach().cpu().numpy().astype(np.float32)
    out = _powf()(arr, np.float32(y)).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(out)).to(x.device)


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.2

    def batch(self, step: int, *, host_slice: slice | None = None) -> dict:
        """Global batch for ``step``: ``{"tokens": [B, S] int64}`` on the
        CPU, the values of the reference's int32 tokens.

        ``host_slice`` selects this host's rows (data-parallel input feeding).
        """
        key = rng.fold_in(rng.key(self.seed), step)
        b = self.global_batch
        u = rng.uniform(key, (b, self.seq_len), minval=1e-6, maxval=1.0)
        rank = torch.floor(xla_powf(u, -1.0 / (self.zipf_alpha - 1.0))) - 1.0
        tokens = torch.clamp(rank, 0, self.vocab_size - 1).to(torch.int64)
        if host_slice is not None:
            tokens = tokens[host_slice]
        return {"tokens": tokens}


def spike_train(key: torch.Tensor, n_channels: int, n_steps: int, rate_hz: float,
                dt_ms: float = 1.0) -> torch.Tensor:
    """Poisson spike raster ``[T, C]`` bool — SNN input pipelines; ``key``
    a threefry key (:func:`repro_torch.core.rng.key`)."""
    p = rate_hz * dt_ms / 1000.0
    u = rng.uniform(key, (n_steps, n_channels))
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)
