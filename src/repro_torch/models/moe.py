"""Mixture-of-Experts layer: token-choice top-k with sort-based dispatch
(``repro/models/moe.py``).

Capacity-bucketed dispatch: each sequence's (token, choice) assignments
are sorted by expert (a stable sort, as ``jnp.argsort``), bucketed into a
static ``[B, E, C, D]`` buffer with ``C = ceil(S k / E cf)`` (overflow
dropped), the experts' FFNs run as batched products over E in the storage
dtype with f32 accumulation, and the results come back weighted by the
renormalised gates. Router math in f32. Shared experts (Qwen2-MoE) are a
plain MLP over every token.

Every step is a gather or a scatter to distinct places, so two calls give
the same bits on the card too: the buffer is filled by a gather (slot c of
expert e holds the token at sorted position ``start_e + c``), and each
token's k contributions are summed by a gather in the order the
reference's scatter-add visits them (by expert, ascending), with no
atomics.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import MLP, act, dense, gelu_tanh, mlp_apply, silu

__all__ = ["MoE", "moe_apply", "route", "dispatch_plan"]

f32 = torch.float32


class MoE(nn.Module):
    """``router`` ``[D, E]``, ``w_gate``/``w_up`` ``[E, D, F]`` (scaled by
    ``1/sqrt(D)``), ``w_down`` ``[E, F, D]`` (by ``1/sqrt(F)``), drawn in
    that order from ``gen`` in the storage dtype, and with shared experts an
    :class:`~repro_torch.models.layers.MLP` ``shared`` of width
    ``d_shared``. ``gen`` None leaves them uninitialised."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, dtype: torch.dtype):
        super().__init__()
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_expert, m.n_experts

        def draw(shape, scale):
            if gen is None:
                return nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)
            w = torch.randn(shape, generator=gen, dtype=f32) * scale
            return nn.Parameter(w.to(dtype), requires_grad=False)

        scale = (1.0 / d) ** 0.5
        self.router = draw((d, e), scale)
        self.w_gate = draw((e, d, f), scale)
        self.w_up = draw((e, d, f), scale)
        self.w_down = draw((e, f, d), (1.0 / f) ** 0.5)
        self.shared = MLP(gen, cfg.mlp, d, m.d_shared, dtype) if m.n_shared else None


def route(p, x: torch.Tensor, cfg: ArchConfig, act_to: torch.dtype | None = None):
    """``(probs [B, S, E] f32, eids [B, S, k] int64, gates [B, S, k] f32)``:
    the softmax of the router's logits, the top k experts of each token
    (ties to the lower index, as ``jax.lax.top_k``: a stable descending
    sort) and their probabilities renormalised to sum to 1."""
    logits = dense(x, p.router, act_to=act_to).to(f32)
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = u / u.sum(dim=-1, keepdim=True)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.top_k
    gates = vals[..., :k]
    return probs, idx[..., :k], gates / gates.sum(dim=-1, keepdim=True)


def dispatch_plan(eids: torch.Tensor, n_experts: int, cap: int) -> dict:
    """The reference's per-sequence dispatch of ``eids`` ``[B, S, k]``:
    ``slot`` ``[B, S, k]`` (each assignment's place in its expert's
    bucket), ``keep`` (``slot < cap``: overflow dropped), and for the
    buffer, ``token`` ``[B, E, cap]`` (the token in each slot, 0 where
    ``filled`` is False)."""
    b, s, k = eids.shape
    dev = eids.device
    flat_e = eids.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)  # stable, as jnp.argsort
    se = torch.gather(flat_e, 1, order)
    counts = F.one_hot(flat_e, n_experts).sum(dim=1)  # [B, E]
    starts = torch.cumsum(counts, dim=1) - counts
    pos_in_e = torch.arange(s * k, device=dev) - torch.gather(starts, 1, se)
    slot = torch.empty_like(pos_in_e).scatter_(1, order, pos_in_e).reshape(b, s, k)
    c = torch.arange(cap, device=dev)
    filled = c[None, None, :] < counts[:, :, None]  # [B, E, cap]
    at = (starts[:, :, None] + c).clamp(max=s * k - 1).reshape(b, -1)
    token = torch.where(filled, (torch.gather(order, 1, at) // k).reshape(b, n_experts, cap), 0)
    return {"slot": slot, "keep": slot < cap, "token": token, "filled": filled}


def _experts(p, buf: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The experts' FFNs on ``buf`` ``[B, E, C, D]`` f32: inputs rounded to
    the weights' dtype (fp16/bf16), products accumulated in f32, the gate's
    activation in f32 and the hidden layer rounded to the weights' dtype
    again, as the reference's einsums with ``preferred_element_type``."""
    b, e, c, d = buf.shape
    comp = p.w_gate.dtype if p.w_gate.dtype in (torch.float16, torch.bfloat16) else f32
    xb = buf.to(comp).to(f32).transpose(0, 1).reshape(e, b * c, d)
    gate = torch.bmm(xb, p.w_gate.to(f32))
    up = torch.bmm(xb, p.w_up.to(f32))
    hidden = silu(gate) if cfg.mlp == "swiglu" else gelu_tanh(gate)
    hidden = (hidden * up).to(comp).to(f32)
    out = torch.bmm(hidden, p.w_down.to(f32))  # [E, B*C, D]
    return out.reshape(e, b, c, d).transpose(0, 1)


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig, act_to: torch.dtype | None = None, *,
              stats: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, D]`` -> ``(out [B, S, D], aux)``, out in the activation
    dtype ``act_to``, aux the Switch load-balance loss ``E * sum_e frac_e *
    mean_prob_e`` (f32 scalar), or with ``stats`` its two factors
    ``[frac, mean_prob]`` (``[2, E]``, means over B and S). Dispatch is per
    sequence, with capacity ``ceil(S k / E cf)``."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_experts, m.top_k
    cap = int(math.ceil(s * k / e * m.capacity_factor))
    probs, eids, gates = route(p, x, cfg, act_to)
    frac = F.one_hot(eids, e).to(f32).sum(dim=2).mean(dim=(0, 1))
    if stats:
        aux = torch.stack([frac, probs.mean(dim=(0, 1))])
    else:
        aux = e * torch.sum(frac * probs.mean(dim=(0, 1)))

    dp = dispatch_plan(eids, e, cap)
    xf = x.to(f32)
    tok = dp["token"].reshape(b, e * cap, 1).expand(b, e * cap, d)
    buf = torch.where(dp["filled"][..., None],
                      torch.gather(xf, 1, tok).reshape(b, e, cap, d), 0.0)
    eout = _experts(p, buf, cfg)  # [B, E, C, D]

    # Each token's k contributions, in the order of its experts' ids.
    eord, jord = torch.sort(eids, dim=-1)
    slot = torch.gather(dp["slot"], 2, jord).clamp(max=cap - 1)
    wgt = torch.gather(gates * dp["keep"].to(f32), 2, jord)
    flat = (eord * cap + slot).reshape(b, s * k, 1).expand(b, s * k, d)
    contrib = torch.gather(eout.reshape(b, e * cap, d), 1, flat).reshape(b, s, k, d)
    contrib = contrib * wgt[..., None]
    out = torch.zeros((b, s, d), dtype=f32, device=x.device)
    for j in range(k):
        out = out + contrib[:, :, j]
    if m.n_shared:
        out = out + mlp_apply(cfg.mlp, x, p.shared, act_to)
    return act(out, act_to), aux
