"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, with PyTorch ops in
the reference's term order. The wrappers in :mod:`repro_torch.kernels.ops`
take these for tensors on the CPU; ``chip_smoke.py`` holds each kernel
against its plain version on the card. Nothing on the card's path calls
them.
"""
from __future__ import annotations

import torch

__all__ = ["izh4_ref", "syn_matmul_ref", "syn_gather_ref", "fused_tick_ref",
           "stdp_update_ref", "stdp_gather_ref"]

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


def _check_indices(what: str, idx, n: int) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"{what}: indices span [{int(idx.min())}, "
                         f"{int(idx.max())}], outside [0, {n})")


def syn_gather_ref(spikes, idx, w):
    """CSR fan-in drive: ``out[q] = Σ_k spikes[idx[q, k]] * w[q, k]``.

    Padded entries carry weight +0.0, so they contribute an exact +0.0.
    Raises ``IndexError`` for an index outside ``[0, P)``.
    """
    _check_indices("syn_gather", idx, spikes.shape[0])
    g = spikes.to(f32)[idx.to(torch.int64)]
    return (g * w.to(f32)).sum(dim=1)


def fused_tick_ref(v, u, ring, gen_row, is_gen, a, b, c, d, t: int, *,
                   dense=(), csr=(), ring_len: int, dt: float = 1.0,
                   substeps: int = 2):
    """One whole tick on unpadded operands, as the reference's
    ``kernels/ref.py:fused_tick_ref``: ring slot read and zero, IZH4,
    generator override, propagation, one ring commit per distinct delay.

    ``ring`` ``[L, N]`` single-channel storage-dtype ring; ``gen_row`` and
    ``is_gen`` ``[N]`` bool; ``dense`` iterates ``(pre_start, post_start,
    delay_ms, W [P, Q])``, ``csr`` ``(post_start, delay_ms, idx [Q, F]
    global ids, w [Q, F])``. Drives land per delay in an f32 accumulator,
    dense buckets first, then CSR ones, each in its list's order. Returns
    ``(v', u', spikes, ring', i_syn)``; ``ring`` is left as it was.
    """
    n = v.shape[0]
    slot = t % ring_len
    i_syn = ring[slot].to(f32)
    ring = ring.clone()
    ring[slot].zero_()
    v1, u1, spiked = izh4_ref(v, u, i_syn, a, b, c, d, dt=dt, substeps=substeps)
    v2 = torch.where(is_gen, c, v1.to(f32)).to(v.dtype)
    u2 = torch.where(is_gen, 0.0, u1.to(f32)).to(u.dtype)
    spikes = torch.where(is_gen, gen_row, spiked)
    sf = spikes.to(f32)
    acc: dict[int, torch.Tensor] = {}

    def add(dly, qs, drive):
        a_ = acc.get(dly)
        if a_ is None:
            a_ = acc[dly] = torch.zeros((n,), dtype=f32, device=v.device)
        a_[qs:qs + drive.shape[0]] += drive

    for ps, qs, dly, w in dense:
        add(dly, qs, syn_matmul_ref(sf[None, ps:ps + w.shape[0]], w)[0])
    for qs, dly, idx, w in csr:
        add(dly, qs, syn_gather_ref(sf, idx, w))
    for dly in sorted(acc):
        ring[(t + dly) % ring_len] += acc[dly].to(ring.dtype)
    return v2, u2, spikes, ring, i_syn


def stdp_update_ref(w, mask, pre_trace, post_trace, pre_spikes, post_spikes, *,
                    a_plus: float, a_minus: float, w_min: float, w_max: float):
    """Dense pair-based STDP on ``w [P, Q]`` (storage dtype): ``w + a⁺·(pre_t
    ⊗ post_s) − a⁻·(pre_s ⊗ post_t)``, clipped to ``[w_min, w_max]``,
    +0.0 outside ``mask``, cast back to w's dtype."""
    wf = w.to(f32)
    ltp = a_plus * torch.outer(pre_trace.to(f32), post_spikes.to(f32))
    ltd = a_minus * torch.outer(pre_spikes.to(f32), post_trace.to(f32))
    wf = torch.clamp(wf + ltp - ltd, w_min, w_max)
    return torch.where(mask, wf, 0.0).to(w.dtype)


def stdp_gather_ref(w, idx, valid, pre_trace, post_trace, pre_spikes,
                    post_spikes, *, a_plus: float, a_minus: float,
                    w_min: float, w_max: float):
    """Pair-based STDP on CSR fan-in rows (``w``/``idx``/``valid`` [Q, F]):
    ``dw[q, k] = a⁺·(pre_t[idx[q, k]]·post_s[q]) −
    a⁻·(pre_s[idx[q, k]]·post_t[q])``, clipped, +0.0 where not ``valid``,
    cast back. Raises ``IndexError`` for an index outside ``[0, P)``."""
    _check_indices("stdp_gather", idx, pre_trace.shape[0])
    ii = idx.to(torch.int64)
    post_s = post_spikes.to(f32)[:, None]
    ltp = a_plus * (pre_trace.to(f32)[ii] * post_s)
    ltd = a_minus * (pre_spikes.to(f32)[ii] * post_trace.to(f32)[:, None])
    wf = torch.clamp(w.to(f32) + ltp - ltd, w_min, w_max)
    return torch.where(valid, wf, 0.0).to(w.dtype)
