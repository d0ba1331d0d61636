"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, with PyTorch ops in
the reference's term order. The wrappers in :mod:`repro_torch.kernels.ops`
take these for tensors on the CPU; ``chip_smoke.py`` holds each kernel
against its plain version on the card. Nothing on the card's path calls
them.
"""
from __future__ import annotations

import torch

__all__ = ["izh4_ref", "syn_matmul_ref", "syn_gather_ref"]

f32 = torch.float32


def izh4_ref(v, u, i_syn, a, b, c, d, *, dt: float = 1.0, substeps: int = 2):
    """IZH4 update + spike + reset; f32 math, storage dtype preserved.

    Each Euler substep takes (dv, du) from the same pre-step (v, u), with
    the reference's term order
    ``0.04*v*v + 5.0*v + 140.0 - u + i_syn``, ``a*(b*v - u)``, ``v + h*dv``.
    Eager PyTorch rounds every operation on its own (no FMA contraction).
    """
    out_dtype = v.dtype
    v = v.to(f32)
    u = u.to(f32)
    i_syn = i_syn.to(f32)
    h = dt / substeps
    for _ in range(substeps):
        dv = 0.04 * v * v + 5.0 * v + 140.0 - u + i_syn
        du = a * (b * v - u)
        v = v + h * dv
        u = u + h * du
    spiked = v >= 30.0
    v = torch.where(spiked, c, v)
    u = torch.where(spiked, u + d, u)
    return v.to(out_dtype), u.to(out_dtype), spiked


def syn_matmul_ref(x, w):
    """x [M, K] @ w [K, N], storage-dtype weights decoded to f32 (softfp)."""
    return torch.matmul(x.to(f32), w.to(f32))


def syn_gather_ref(spikes, idx, w):
    """CSR fan-in drive: ``out[q] = Σ_k spikes[idx[q, k]] * w[q, k]``.

    Padded entries carry weight +0.0, so they contribute an exact +0.0.
    Raises ``IndexError`` for an index outside ``[0, P)``.
    """
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= spikes.shape[0]):
        raise IndexError(f"syn_gather: indices span [{int(idx.min())}, "
                         f"{int(idx.max())}], outside [0, {spikes.shape[0]})")
    g = spikes.to(f32)[idx.to(torch.int64)]
    return (g * w.to(f32)).sum(dim=1)
