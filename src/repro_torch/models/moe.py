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
atomics. Over a model group (:func:`moe_group`) the same steps run on a
range of the experts (EP) or of every expert's hidden dim (TP), the
routing whole on every rank.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded as sh
from repro_torch.models.layers import MLP, act, dense, gelu_tanh, mlp_apply, silu

__all__ = ["MoE", "moe_apply", "moe_group", "route", "dispatch_plan"]

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


def _capacity(cfg: ArchConfig, s: int) -> int:
    m = cfg.moe
    return int(math.ceil(s * m.top_k / m.n_experts * m.capacity_factor))


def _stats(probs, eids, e: int):
    """``(frac, mean_prob)`` ``[E]`` each: the share of assignments and the
    mean router probability per expert, over B and S."""
    return F.one_hot(eids, e).to(f32).sum(dim=2).mean(dim=(0, 1)), probs.mean(dim=(0, 1))


def _dispatch(x: torch.Tensor, dp: dict, experts: tuple[int, int], cap: int) -> torch.Tensor:
    """The buffer ``[B, E_r, cap, D]`` f32 of experts ``[lo, hi)``: slot c
    of expert e holds its token's row (zeros where unfilled)."""
    b, _, d = x.shape
    lo, hi = experts
    n = hi - lo
    tok = dp["token"][:, lo:hi].reshape(b, n * cap, 1).expand(b, n * cap, d)
    return torch.where(dp["filled"][:, lo:hi, :, None],
                       torch.gather(x.to(f32), 1, tok).reshape(b, n, cap, d), 0.0)


def _order(eids, gates, dp: dict, cap: int):
    """Each token's k assignments in the order of their experts' ids:
    ``(expert, slot, weight)`` ``[B, S, k]``, the slot clamped into the
    buffer and the weight the renormalised gate (0 where dropped)."""
    eord, jord = torch.sort(eids, dim=-1)
    slot = torch.gather(dp["slot"], 2, jord).clamp(max=cap - 1)
    wgt = torch.gather(gates * dp["keep"].to(f32), 2, jord)
    return eord, slot, wgt


def _pick(eout: torch.Tensor, eord, slot, experts: tuple[int, int], cap: int,
          n_experts: int) -> torch.Tensor:
    """``[B, S', k, D]``: each assignment's row of ``eout`` (``[B, E_r, cap,
    D]``, experts ``[lo, hi)`` of ``n_experts``), zeros for an expert
    outside the range."""
    b, s, k = eord.shape
    d = eout.shape[-1]
    lo, hi = experts
    flat = (eord - lo) * cap + slot
    owned = None
    if (lo, hi) != (0, n_experts):
        owned = (eord >= lo) & (eord < hi)
        flat = torch.where(owned, flat, 0)
    rows = torch.gather(eout.reshape(b, -1, d), 1, flat.reshape(b, s * k, 1).expand(b, s * k, d))
    rows = rows.reshape(b, s, k, d)
    return rows if owned is None else torch.where(owned[..., None], rows, 0.0)


def _weigh(rows: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """``sum_j wgt_j rows_j`` over the k assignments in order, f32 (the
    reference's scatter-add order)."""
    contrib = rows * wgt[..., None]
    out = torch.zeros(rows.shape[:2] + rows.shape[3:], dtype=f32, device=rows.device)
    for j in range(rows.shape[2]):
        out = out + contrib[:, :, j]
    return out


def moe_apply(p, x: torch.Tensor, cfg: ArchConfig, act_to: torch.dtype | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, D]`` -> ``(out [B, S, D], aux)``, out in the activation
    dtype ``act_to``, aux the Switch load-balance loss ``E * sum_e frac_e *
    mean_prob_e`` (f32 scalar; ``frac`` and ``mean_prob`` means over B and
    S). Dispatch is per sequence, with capacity ``ceil(S k / E cf)``."""
    m = cfg.moe
    e = m.n_experts
    cap = _capacity(cfg, x.shape[1])
    probs, eids, gates = route(p, x, cfg, act_to)
    frac, mean_prob = _stats(probs, eids, e)
    aux = e * torch.sum(frac * mean_prob)
    dp = dispatch_plan(eids, e, cap)
    eout = _experts(p, _dispatch(x, dp, (0, e), cap), cfg)  # [B, E, C, D]
    eord, slot, wgt = _order(eids, gates, dp, cap)
    out = _weigh(_pick(eout, eord, slot, (0, e), cap, e), wgt)
    if m.n_shared:
        out = out + mlp_apply(cfg.mlp, x, p.shared, act_to)
    return act(out, act_to), aux


def moe_group(ps: list, xs: list, cfg: ArchConfig, run) -> tuple[list, torch.Tensor]:
    """:func:`moe_apply` over a model group (``run``: the group's
    ``transformer.GroupRun``): ``ps`` each rank's view of its ranges, ``xs``
    each rank's copy of the normed input over the whole sequence. Returns
    the ranks' outputs in the residual stream's layout (each rank's
    sequence range under ``seq_shard``, else the whole) and the routing
    statistics ``[2, E]`` of rank 0.

    Every rank routes the whole sequence with the whole router (the same
    bits on each: dispatch and capacity are per sequence). EP (the plan's
    ``experts`` a range): a rank fills and runs its experts only; under
    ``seq_shard`` an all-to-all brings each rank its tokens' rows from the
    other ranks' experts, else an all-gather along E brings every expert's;
    each rank combines its own sequence range in the reference's order, so
    the routed output is the single-device layer's bit for bit (without
    ``seq_shard`` the ranges are then summed onto every rank: each element
    one nonzero part). TP (``expert_ff`` a range of every expert): each
    rank combines every token from its partial expert outputs, and the
    partials are summed over the group in rank order (a reduce-scatter
    along the sequence under ``seq_shard``, as ``w_down``'s). Shared
    experts split ``d_shared`` as the dense MLP does; their sum is added
    after the routed one, as the reference adds it. Each rank's gates take
    the gradient of its own combine only; rank 0's probabilities that of
    the statistics."""
    m = cfg.moe
    e, grp, plan = m.n_experts, run.grp, run.plan
    cap = _capacity(cfg, xs[0].shape[1])
    ep = meshlib.expert_parallel(cfg, len(plan))
    routed, stats = [], None
    pieces, orders = [], []
    for r, (p, x) in enumerate(zip(ps, xs)):
        with grp.on(r):
            probs, eids, gates = route(p, x, cfg, run.act_to)
            if r == 0:
                stats = torch.stack(_stats(probs, eids, e))
            dp = dispatch_plan(eids, e, cap)
            pl = plan[r]
            eout = None
            if pl.experts[1] > pl.experts[0] and pl.expert_ff[1] > pl.expert_ff[0]:
                eout = _experts(p, _dispatch(x, dp, pl.experts, cap), cfg)
            order = _order(eids, gates, dp, cap)
            orders.append(order)
            if not ep:  # TP: the partial combine of every token
                routed.append(None if eout is None else _weigh(
                    _pick(eout, order[0], order[1], pl.experts, cap, e), order[2]))
            elif run.seq_shard:  # EP: the rows of its experts, for each rank's tokens
                rows = _pick(eout, order[0], order[1], pl.experts, cap, e)
                pieces.append([rows[:, lo:hi] for lo, hi in run.seq])
            else:
                pieces.append(eout)
    if not ep:
        routed = run.reduce(routed)
    elif run.seq_shard:
        got = sh.all_to_all(grp, pieces)
        for j, (lo, hi) in enumerate(run.seq):
            with grp.on(j):
                rows = got[j][0]
                for t in got[j][1:]:  # one owner per row, zeros elsewhere: exact
                    rows = rows + t
                routed.append(_weigh(rows, orders[j][2][:, lo:hi]))
    else:
        whole = sh.seq_gather(grp, pieces, [pl.experts for pl in plan], dim=1)
        own = []
        for j, (lo, hi) in enumerate(run.seq):
            with grp.on(j):
                eord, slot, wgt = orders[j]
                own.append(_weigh(_pick(whole[j], eord[:, lo:hi], slot[:, lo:hi], (0, e), cap, e),
                                  wgt[:, lo:hi]))
        routed = run.spread(own)
    if m.n_shared:
        parts = []
        for r, (p, x) in enumerate(zip(ps, xs)):
            with grp.on(r):
                lo, hi = plan[r].shared
                parts.append(mlp_apply(cfg.mlp, x, p.shared, run.act_to) if hi > lo else None)
        shared = run.reduce(parts)
        routed = [y + z for y, z in zip(routed, shared)]
    out = []
    for r, y in enumerate(routed):
        with grp.on(r):
            out.append(act(y, run.act_to))
    return out, stats
