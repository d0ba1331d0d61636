"""Mamba-1 block (falcon-mamba): the selective SSM
(``repro/models/mamba.py``).

The full-sequence path (train and prefill) runs the linear recurrence
over the sequence with :func:`repro_torch.models.scan.associative_scan`,
the reference's ``jax.lax.associative_scan`` recursion (log-depth, a few
element-wise launches per level on the card); decode is the O(1)
single-step recurrence, carrying the last K-1 raw conv inputs and the
``[B, Di, N]`` state in the cache's dtype. The reference's own lever
``SSM_CHUNK`` (:func:`set_ssm_chunk`) scans chunks of that many steps
one after another instead, the state carried between them. Over a model
group (:func:`mamba_group`, :func:`mamba_decode_group`) each rank runs a
channel range of ``d_inner``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharded as sh
from repro_torch.models.layers import act, dense, init_zeros, silu, softplus
from repro_torch.models.scan import associative_scan, causal_conv, chunked_scan, fma

__all__ = ["Mamba", "mamba_apply", "mamba_group", "init_mamba_cache", "mamba_decode_step",
           "mamba_decode_group", "set_ssm_chunk", "SSM_CHUNK"]

f32 = torch.float32

# 0: one associative scan over S; > 0: a sequential scan over chunks of
# this many steps (S a multiple of it), associative within each chunk.
SSM_CHUNK = [0]


def set_ssm_chunk(n: int) -> None:
    SSM_CHUNK[0] = int(n)


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, dt_rank, s.d_state, s.d_conv


class Mamba(nn.Module):
    """The mixer's parameters, as the reference's tree: ``in_proj`` ``[D,
    2 Di]``, ``conv_w`` ``[K, Di]``, ``conv_b``, ``x_proj`` ``[Di, R +
    2N]``, ``dt_proj`` ``[R, Di]``, ``dt_bias``, ``out_proj`` ``[Di, D]``
    in the storage dtype, and ``A_log`` ``[Di, N]`` (``log(1..N)``, S4D-real)
    and ``D`` (ones) in f32. Weights are normal draws from ``gen`` scaled by
    ``1/sqrt(fan-in)`` (the conv by 0.3); ``dt_bias`` is the softplus
    inverse of log-uniform steps in [1e-3, 1e-1]. ``gen`` None leaves
    them uninitialised, to be carried in."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, dtype: torch.dtype):
        super().__init__()
        d_in, dt_rank, n, k = _dims(cfg)
        d = cfg.d_model

        def draw(shape, scale, dt=dtype):
            if gen is None:
                return nn.Parameter(torch.empty(shape, dtype=dt), requires_grad=False)
            w = torch.randn(shape, generator=gen, dtype=f32) * scale
            return nn.Parameter(w.to(dt), requires_grad=False)

        self.in_proj = draw((d, 2 * d_in), (1.0 / d) ** 0.5)
        self.conv_w = draw((k, d_in), 0.3)
        self.conv_b = init_zeros(d_in, dtype)
        self.x_proj = draw((d_in, dt_rank + 2 * n), (1.0 / d_in) ** 0.5)
        self.dt_proj = draw((dt_rank, d_in), (1.0 / dt_rank) ** 0.5)
        if gen is None:
            dt_bias = torch.empty((d_in,), dtype=f32)
        else:
            lo, hi = math.log(1e-3), math.log(1e-1)
            u = torch.rand((d_in,), generator=gen, dtype=f32) * (hi - lo) + lo
            dt_bias = torch.log(torch.expm1(torch.exp(u)))
        self.dt_bias = nn.Parameter(dt_bias.to(dtype), requires_grad=False)
        a_log = torch.log(torch.arange(1, n + 1, dtype=f32)).expand(d_in, n).contiguous()
        self.A_log = nn.Parameter(a_log, requires_grad=False)
        self.D = nn.Parameter(torch.ones((d_in,), dtype=f32), requires_grad=False)
        self.out_proj = draw((d_in, d), (1.0 / d_in) ** 0.5)


def _ssm_scan(delta_a: torch.Tensor, delta_bu: torch.Tensor) -> torch.Tensor:
    chunk = SSM_CHUNK[0]
    s = delta_a.shape[1]
    if chunk <= 0 or s <= chunk or s % chunk:
        return associative_scan(delta_a, delta_bu)[1]
    return chunked_scan(delta_a, delta_bu, chunk)


def _discretise(p, proj, cfg, act_to):
    """``(delta, B, C)`` of ``x_proj``'s output ``[.., R + 2N]``."""
    _, dt_rank, n, _ = _dims(cfg)
    dt, b_mat, c_mat = torch.split(proj, [dt_rank, n, n], dim=-1)
    delta = softplus(dense(dt, p.dt_proj, act_to=act_to) + p.dt_bias.to(f32))
    return delta, b_mat, c_mat


def _mix_in(p, x, cfg, act_to, return_state):
    """``(raw, z, xin)``: ``in_proj``'s two halves and the conv's output."""
    k = cfg.ssm.d_conv
    if return_state and x.shape[1] < k - 1:
        raise ValueError(f"a prompt of {x.shape[1]} tokens is shorter than the conv's "
                         f"history of {k - 1}: the decode cache has no layout for it")
    raw, z = torch.chunk(dense(x, p.in_proj, act_to=act_to), 2, dim=-1)
    return raw, z, silu(causal_conv(raw, p.conv_w, p.conv_b))


def _mix_out(p, raw, z, xin, proj, cfg, act_to, return_state):
    """The selective scan from ``x_proj``'s output ``proj``, the gate and
    ``out_proj``: ``(out, state)``."""
    delta, b_mat, c_mat = _discretise(p, proj, cfg, act_to)
    a = -torch.exp(p.A_log)  # [Di, N]
    delta_a = act(torch.exp(delta[..., None] * a), act_to)  # [B, S, Di, N]
    delta_bu = act((delta * xin)[..., None] * b_mat[..., None, :], act_to)
    h = _ssm_scan(delta_a, delta_bu)
    y = torch.einsum("bsdn,bsn->bsd", h, c_mat.to(h.dtype)) + p.D * xin
    y = y * silu(z)
    out = dense(y, p.out_proj, act_to=act_to)
    if return_state:
        return out, {"conv": raw[:, -(cfg.ssm.d_conv - 1):], "ssm": h[:, -1]}
    return out, None


def mamba_apply(p, x: torch.Tensor, cfg: ArchConfig, act_to: torch.dtype | None = None,
                return_state: bool = False):
    """Full-sequence selective SSM on the weights of ``p`` (a
    :class:`Mamba` or any object with its attributes). x ``[B, S, D]`` ->
    ``([B, S, D], state)``, projection outputs in the activation dtype
    ``act_to``; ``state`` is the decode cache at the last position
    (``{"conv": the last K-1 raw conv inputs, "ssm": h}``) with
    ``return_state``, else None. The discretised ``exp(delta A)`` and
    ``delta B u`` round to the activation dtype before the scan, as the
    reference's ``act`` does."""
    raw, z, xin = _mix_in(p, x, cfg, act_to, return_state)
    return _mix_out(p, raw, z, xin, dense(xin, p.x_proj, act_to=act_to), cfg, act_to,
                    return_state)


def mamba_group(ps: list, xs: list, cfg: ArchConfig, run, return_state: bool = False):
    """:func:`mamba_apply` over a model group (``run``: the group's
    ``transformer.GroupRun``), each rank on its channel range of ``d_inner``
    (``ps`` each rank's view of its ranges: both halves of ``in_proj``, the
    conv, ``dt_proj``'s columns, ``dt_bias``, ``A_log``'s rows, ``D``,
    ``x_proj``'s and ``out_proj``'s rows), ``xs`` each rank's copy of the
    normed input over the whole sequence. The conv, the discretisation,
    the scan and the gate run per channel, as the whole layer runs them on
    those channels; ``x_proj``'s partial products are summed over the group
    in rank order (:func:`repro_torch.launch.sharded.group_psum`) before
    the split into dt, B and C. Returns each rank's partial ``out_proj``
    output (to be summed over the group) and, with ``return_state``, its
    channels of the decode state."""
    grp = run.grp
    mids, parts = [], []
    for r, (p, x) in enumerate(zip(ps, xs)):
        with grp.on(r):
            raw, z, xin = _mix_in(p, x, cfg, run.act_to, return_state)
            mids.append((raw, z, xin))
            parts.append(dense(xin, p.x_proj))
    projs = sh.group_psum(grp, parts)
    outs, states = [], []
    for r, (p, (raw, z, xin), proj) in enumerate(zip(ps, mids, projs)):
        with grp.on(r):
            out, st = _mix_out(p, raw, z, xin, act(proj, run.act_to), cfg, run.act_to,
                               return_state)
        outs.append(out)
        states.append(st)
    return outs, states


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype, device) -> dict:
    d_in, _, n, k = _dims(cfg)
    return {"conv": torch.zeros((batch, k - 1, d_in), dtype=dtype, device=device),
            "ssm": torch.zeros((batch, d_in, n), dtype=dtype, device=device)}


def _decode_in(p, x, cache, act_to):
    """``(z, conv_in, xin)`` of one token: ``in_proj``'s gate half, the conv
    window (the cached K-1 raw inputs and this one) and the conv's output."""
    raw, z = torch.chunk(dense(x, p.in_proj, act_to=act_to), 2, dim=-1)  # [B, 1, Di]
    conv_in = torch.cat([cache["conv"].to(raw.dtype), raw], dim=1)  # [B, K, Di]
    conv_out = torch.einsum("bkd,kd->bd", conv_in, p.conv_w.to(raw.dtype))
    return z, conv_in, silu(conv_out + p.conv_b.to(raw.dtype))[:, None]


def _decode_out(p, z, conv_in, xin, proj, cache, cfg, act_to):
    """One step of the recurrence from ``x_proj``'s output ``proj``, the
    gate and ``out_proj``; the cache updated in place."""
    delta, b_mat, c_mat = _discretise(p, proj, cfg, act_to)
    a = -torch.exp(p.A_log)
    delta_a = torch.exp(delta[..., None] * a)[:, 0]  # [B, Di, N]
    delta_bu = ((delta * xin)[..., None] * b_mat[..., None, :])[:, 0]
    h = fma(delta_a, cache["ssm"].to(f32), delta_bu)
    y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0].to(h.dtype)) + p.D * xin[:, 0]
    y = (y * silu(z[:, 0]))[:, None]
    out = dense(y, p.out_proj, act_to=act_to)
    cache["conv"].copy_(conv_in[:, 1:])
    cache["ssm"].copy_(h)
    return out


def mamba_decode_step(p, x: torch.Tensor, cache: dict, cfg: ArchConfig,
                      act_to: torch.dtype | None = None) -> torch.Tensor:
    """One-token recurrence: x ``[B, 1, D]`` -> ``[B, 1, D]``; ``cache``
    (``conv`` ``[B, K-1, Di]``, the last K-1 raw conv inputs, and ``ssm``
    ``[B, Di, N]``) is updated in place, cast to its dtype."""
    z, conv_in, xin = _decode_in(p, x, cache, act_to)
    return _decode_out(p, z, conv_in, xin, dense(xin, p.x_proj, act_to=act_to), cache, cfg,
                       act_to)


def mamba_decode_group(ps: list, xs: list, caches: list, cfg: ArchConfig, run) -> list:
    """:func:`mamba_decode_step` over a model group (``run``: the group's
    ``transformer.GroupRun``), each rank on its channel range of ``d_inner``
    (``ps`` each rank's view of its ranges, as :func:`mamba_group`'s; ``xs``
    each rank's copy of the normed token; ``caches`` each rank's channels
    of the layer's ``conv`` and ``ssm``, updated in place). ``x_proj``'s
    partial products are summed over the group in rank order before the
    split into dt, B and C. Returns each rank's partial ``out_proj`` output
    (to be summed over the group)."""
    grp = run.grp
    mids, parts = [], []
    for r, (p, x, c) in enumerate(zip(ps, xs, caches)):
        with grp.on(r):
            mids.append(_decode_in(p, x, c, run.act_to))
            parts.append(dense(mids[-1][2], p.x_proj))
    projs = sh.group_sum(grp, parts)
    outs = []
    for r, (p, (z, conv_in, xin), proj, c) in enumerate(zip(ps, mids, projs, caches)):
        with grp.on(r):
            outs.append(_decode_out(p, z, conv_in, xin, act(proj, run.act_to), c, cfg,
                                    run.act_to))
    return outs
