"""RG-LRU recurrent block (RecurrentGemma / Griffin)
(``repro/models/rglru.py``).

Per channel (Griffin eq. 6-8):

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = exp(-c softplus(lam) r_t)         c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

wrapped in a K = 4 temporal conv and a GELU output gate. Train and
prefill run the recurrence with
:func:`repro_torch.models.scan.associative_scan` over ``[B, S, W]``;
decode is the single-step update carrying ``h`` ``[B, W]`` and the last
three raw conv inputs in the cache's dtype. Over a model group
(:func:`rglru_group`, :func:`rglru_decode_group`) each rank runs a
channel range of the width.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import sharded as sh
from repro_torch.models.layers import dense, gelu_tanh, init_zeros, sigmoid, softplus
from repro_torch.models.scan import associative_scan, causal_conv, fma

__all__ = ["RGLRU", "rglru_apply", "rglru_group", "init_rglru_cache", "rglru_decode_step",
           "rglru_decode_group"]

f32 = torch.float32
_C = 8.0


def _width(cfg: ArchConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


class RGLRU(nn.Module):
    """The block's parameters, as the reference's tree: ``in_proj`` and
    ``gate_proj`` ``[D, W]``, ``conv_w`` ``[4, W]``, ``conv_b``, ``w_a``
    and ``w_x`` ``[W, W]``, ``out_proj`` ``[W, D]`` in the storage dtype;
    ``b_a``, ``b_x`` (zeros) and ``lam`` in f32, ``lam`` the softplus
    inverse of ``-log(u) / 8`` for u uniform in (0.9, 0.999), so that
    ``a`` lies there at ``r = 1``. ``gen`` None leaves them
    uninitialised, to be carried in."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, dtype: torch.dtype):
        super().__init__()
        d, w = cfg.d_model, _width(cfg)

        def draw(shape, scale):
            if gen is None:
                return nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)
            x = torch.randn(shape, generator=gen, dtype=f32) * scale
            return nn.Parameter(x.to(dtype), requires_grad=False)

        sd, sw = (1.0 / d) ** 0.5, (1.0 / w) ** 0.5
        self.in_proj = draw((d, w), sd)
        self.gate_proj = draw((d, w), sd)
        self.conv_w = draw((4, w), 0.3)
        self.conv_b = init_zeros(w, dtype)
        self.w_a = draw((w, w), sw)
        self.b_a = init_zeros(w, f32)
        self.w_x = draw((w, w), sw)
        self.b_x = init_zeros(w, f32)
        if gen is None:
            lam = torch.empty((w,), dtype=f32)
        else:
            u = torch.rand((w,), generator=gen, dtype=f32) * (0.999 - 0.9) + 0.9
            lam = torch.log(torch.expm1(-torch.log(u) / _C))
        self.lam = nn.Parameter(lam, requires_grad=False)
        self.out_proj = draw((w, d), sw)


def _gates(p, xc, act_to, own=None):
    """``(a, gated_in)`` of the conv's output ``xc``; ``own`` (default
    ``xc``) is the conv output of the gates' channels, which ``i * xc``
    reads where ``w_a`` and ``w_x`` read all of ``xc``."""
    own = xc if own is None else own
    r = sigmoid(dense(xc, p.w_a, act_to=act_to) + p.b_a)
    i = sigmoid(dense(xc, p.w_x, act_to=act_to) + p.b_x)
    log_a = -_C * softplus(p.lam.to(f32)) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * own)
    return a, gated_in


def _mix_in(p, x, act_to, return_state):
    """``(raw, gate, xc)``: the two input projections and the conv."""
    if return_state and x.shape[1] < 3:
        raise ValueError(f"a prompt of {x.shape[1]} tokens is shorter than the conv's "
                         "history of 3: the decode cache has no layout for it")
    raw = dense(x, p.in_proj, act_to=act_to)  # [B, S, W]
    gate = dense(x, p.gate_proj, act_to=act_to)
    return raw, gate, causal_conv(raw, p.conv_w, p.conv_b)


def _mix_out(p, raw, gate, a, gated_in, act_to, return_state):
    h = associative_scan(a, gated_in)[1]
    y = h * gelu_tanh(gate)
    out = dense(y, p.out_proj, act_to=act_to)
    if return_state:
        return out, {"h": h[:, -1], "conv": raw[:, -3:]}
    return out, None


def rglru_apply(p, x: torch.Tensor, cfg: ArchConfig, act_to: torch.dtype | None = None,
                return_state: bool = False):
    """Full-sequence recurrent block on the weights of ``p`` (an
    :class:`RGLRU` or any object with its attributes): x ``[B, S, D]`` ->
    ``([B, S, D], state)``, ``state`` the decode cache at the last position
    (``{"h", "conv": the last three raw conv inputs}``) with
    ``return_state``, else None."""
    raw, gate, xc = _mix_in(p, x, act_to, return_state)
    a, gated_in = _gates(p, xc, act_to)
    return _mix_out(p, raw, gate, a, gated_in, act_to, return_state)


def rglru_group(ps: list, xs: list, cfg: ArchConfig, run, return_state: bool = False):
    """:func:`rglru_apply` over a model group (``run``: the group's
    ``transformer.GroupRun``), each rank on its channel range of the width
    (``ps`` each rank's view of its ranges: the columns of ``in_proj``,
    ``gate_proj``, ``w_a`` and ``w_x``, the conv, ``b_a``, ``b_x``, ``lam``
    and ``out_proj``'s rows), ``xs`` each rank's copy of the normed input
    over the whole sequence. ``w_a`` and ``w_x`` read the whole conv
    output: the group all-gathers it along the width first (a
    reduce-scatter in the backward); the scan and the output gate run per
    channel. Returns each rank's partial ``out_proj`` output (to be summed
    over the group) and, with ``return_state``, its channels of the decode
    state."""
    grp = run.grp
    mids = []
    for r, (p, x) in enumerate(zip(ps, xs)):
        with grp.on(r):
            mids.append(_mix_in(p, x, run.act_to, return_state))
    whole = sh.seq_gather(grp, [xc for _, _, xc in mids], [pl.lru for pl in run.plan], dim=-1)
    outs, states = [], []
    for r, (p, (raw, gate, xc), xw) in enumerate(zip(ps, mids, whole)):
        with grp.on(r):
            a, gated_in = _gates(p, xw, run.act_to, own=xc)
            out, st = _mix_out(p, raw, gate, a, gated_in, run.act_to, return_state)
        outs.append(out)
        states.append(st)
    return outs, states


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype, device) -> dict:
    w = _width(cfg)
    return {"h": torch.zeros((batch, w), dtype=dtype, device=device),
            "conv": torch.zeros((batch, 3, w), dtype=dtype, device=device)}


def _decode_in(p, x, cache, act_to):
    """``(gate, conv_in, xcc)`` of one token: the gate's projection, the conv
    window (the cached three raw inputs and this one) and the conv's
    output."""
    xc = dense(x, p.in_proj, act_to=act_to)  # [B, 1, W]
    gate = dense(x, p.gate_proj, act_to=act_to)
    conv_in = torch.cat([cache["conv"].to(xc.dtype), xc], dim=1)
    co = torch.einsum("bkw,kw->bw", conv_in, p.conv_w.to(xc.dtype))
    return gate, conv_in, (co + p.conv_b.to(xc.dtype))[:, None]


def _decode_out(p, gate, conv_in, a, gated_in, cache, act_to):
    """One step of the recurrence, the output gate and ``out_proj``; the
    cache updated in place."""
    h = fma(a[:, 0], cache["h"].to(f32), gated_in[:, 0])
    y = h[:, None] * gelu_tanh(gate)
    out = dense(y, p.out_proj, act_to=act_to)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_in[:, 1:])
    return out


def rglru_decode_step(p, x: torch.Tensor, cache: dict, cfg: ArchConfig,
                      act_to: torch.dtype | None = None) -> torch.Tensor:
    """One-token recurrence: x ``[B, 1, D]`` -> ``[B, 1, D]``; ``cache``
    (``h`` ``[B, W]``, ``conv`` ``[B, 3, W]``) is updated in place, cast to
    its dtype."""
    gate, conv_in, xcc = _decode_in(p, x, cache, act_to)
    a, gated_in = _gates(p, xcc, act_to)  # [B, 1, W]
    return _decode_out(p, gate, conv_in, a, gated_in, cache, act_to)


def rglru_decode_group(ps: list, xs: list, caches: list, cfg: ArchConfig, run) -> list:
    """:func:`rglru_decode_step` over a model group (``run``: the group's
    ``transformer.GroupRun``), each rank on its channel range of the width
    (``ps`` each rank's view of its ranges, as :func:`rglru_group`'s; ``xs``
    each rank's copy of the normed token; ``caches`` each rank's channels
    of the layer's ``h`` and ``conv``, updated in place). ``w_a`` and
    ``w_x`` read the whole conv output: the group all-gathers it along the
    width first. Returns each rank's partial ``out_proj`` output (to be
    summed over the group)."""
    grp = run.grp
    mids = []
    for r, (p, x, c) in enumerate(zip(ps, xs, caches)):
        with grp.on(r):
            mids.append(_decode_in(p, x, c, run.act_to))
    whole = sh.seq_gather(grp, [xcc for _, _, xcc in mids], [pl.lru for pl in run.plan], dim=-1)
    outs = []
    for r, (p, (gate, conv_in, xcc), xw, c) in enumerate(zip(ps, mids, whole, caches)):
        with grp.on(r):
            a, gated_in = _gates(p, xw, run.act_to, own=xcc)
            outs.append(_decode_out(p, gate, conv_in, a, gated_in, c, run.act_to))
    return outs
