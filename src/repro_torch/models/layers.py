"""Shared LM layers: norms, MLPs, RoPE / M-RoPE, initialisers.

Math convention, as the reference's ``repro/models/layers.py``: parameters
live in the policy's storage dtype; a projection rounds its input to the
weight's dtype (fp16 under the paper's policy) and accumulates in f32;
norms and softmax run in f32 inside. The activation dtype ``act_to`` is
the policy's compute dtype: None (f32) under every policy but
``fp16_opt``, whose projection outputs, norm outputs and prompt embeddings
are cast to bf16, at the places the reference's ``act`` casts them. The
reference keeps it in a process-wide setting; here the step functions
pass it down from their policy as an argument.

A product of two fp16 values is exact in f32, so :func:`dense` upcasts
both operands and runs an f32 matmul (TF32 stays off, PyTorch's default):
the card's fp16 matmul would round its output to fp16.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["act_dtype", "act", "dense", "rmsnorm", "layernorm", "apply_norm", "mlp_apply",
           "rope_table", "mrope_table", "apply_rope", "rope", "mrope", "sigmoid", "softplus",
           "init_dense", "init_zeros", "Norm", "MLP"]

f32 = torch.float32


def act_dtype(compute: torch.dtype) -> torch.dtype | None:
    """The activation dtype of a policy's compute dtype: None for f32."""
    return None if compute == f32 else compute


def act(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """``x`` cast to the activation dtype (kept as it is for None)."""
    return x if dtype is None else x.to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
          act_to: torch.dtype | None = None) -> torch.Tensor:
    """x ``[.., K]`` @ w ``[K, N]`` with f32 accumulation; output in the
    activation dtype ``act_to`` (None: f32)."""
    if w.dtype in (torch.float16, torch.bfloat16):
        x = x.to(w.dtype)
    out = torch.matmul(x.to(f32), w.to(f32))
    if b is not None:
        out = out + b.to(f32)
    return act(out, act_to)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)) * (1.0 + scale.to(f32))


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(f32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * (1.0 + scale.to(f32)) + bias.to(f32)


def apply_norm(kind: str, x: torch.Tensor, p: "Norm") -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p.scale)
    return layernorm(x, p.scale, p.bias)


# -- MLP variants ---------------------------------------------------------------


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``. In f32, ``F.silu`` (one kernel, within an f32 ulp of
    XLA's). Under bf16 activations, ``x * (1 / (1 + exp(-x)))`` with every
    operation rounding to bf16, as XLA evaluates it: ``F.silu`` rounds once
    and differs in about 4 of 10 bf16 outputs."""
    if x.dtype == f32:
        return F.silu(x)
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh form, its default): ``F.gelu`` in f32,
    operation for operation in a narrower activation dtype."""
    if x.dtype == f32:
        return F.gelu(x, approximate="tanh")
    c = torch.tensor(0.7978845608028654, dtype=x.dtype)  # sqrt(2 / pi) in x's dtype
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA lowers it: ``1 / (1 + exp(-x))``."""
    return 1.0 / (1.0 + torch.exp(-x))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``jnp.logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))``, NaN passed through (``F.softplus`` has another
    form, exact above its threshold)."""
    out = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
    return torch.where(torch.isnan(x), x, out)


def mlp_apply(kind: str, x: torch.Tensor, p: "MLP",
              act_to: torch.dtype | None = None) -> torch.Tensor:
    """x ``[.., D]`` -> ``[.., D]``, projection outputs in the activation
    dtype ``act_to``. kinds: swiglu | geglu | gelu | relu2. GELU is the
    tanh form, as ``jax.nn.gelu``'s default."""
    if kind in ("swiglu", "geglu"):
        gate = dense(x, p.w_gate, act_to=act_to)
        up = dense(x, p.w_up, act_to=act_to)
        a = silu(gate) if kind == "swiglu" else gelu_tanh(gate)
        return dense(a * up, p.w_down, act_to=act_to)
    h = dense(x, p.w_up, act_to=act_to)
    if kind == "gelu":
        h = gelu_tanh(h)
    elif kind == "relu2":
        h = torch.square(torch.relu(h))
    else:
        raise ValueError(kind)
    return dense(h, p.w_down, act_to=act_to)


# -- RoPE -------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, dim: int, theta: float) -> torch.Tensor:
    """positions ``[..]`` -> angles ``[.., dim/2]`` (f32)."""
    ar = torch.arange(0, dim, 2, dtype=f32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / dim))
    return positions.to(f32)[..., None] * freqs


def _apply_rot(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs ``(x[..., ::2], x[..., 1::2])`` by the table's angles."""
    x1 = x[..., ::2]
    x2 = x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape)


def rope_table(positions: torch.Tensor, head_dim: int, *, theta: float = 10000.0,
               rotary_pct: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[B, S, 1, d_rot/2]`` for positions ``[B, S]``: the
    rotation :func:`rope` applies, computed once per forward and shared by
    every layer's q and k (the reference computes the same angles in each
    layer)."""
    d_rot = int(head_dim * rotary_pct) & ~1  # even
    ang = _rope_angles(positions, d_rot, theta)[:, :, None, :]
    return torch.cos(ang), torch.sin(ang)


def mrope_table(positions: torch.Tensor, head_dim: int, sections: tuple[int, int, int], *,
                theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) ``[B, S, 1, head_dim/2]`` of Qwen2-VL's multimodal RoPE
    for positions ``[B, S, 3]`` (t, h, w): the rotary frequencies split
    into three contiguous sections, each taking its angle from one of the
    three positions (what :func:`mrope` applies)."""
    d = head_dim
    if sum(sections) != d // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to {d // 2}")
    angs = [_rope_angles(positions[..., i], d, theta) for i in range(3)]  # [B, S, d/2]
    s0, s1, _ = sections
    sel = torch.cat([torch.zeros(s0, dtype=torch.int64), torch.ones(s1, dtype=torch.int64),
                     torch.full((d // 2 - s0 - s1,), 2, dtype=torch.int64)]).to(positions.device)
    ang = torch.where(sel == 0, angs[0], torch.where(sel == 1, angs[1], angs[2]))
    ang = ang[:, :, None, :]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, table: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """x ``[B, S, H, D]`` rotated by a :func:`rope_table` (f32); a table
    narrower than D rotates only the leading part of each head."""
    cos, sin = table
    xf = x.to(f32)
    d_rot = 2 * cos.shape[-1]
    if d_rot == xf.shape[-1]:
        return _apply_rot(xf, cos, sin)
    head, tail = xf[..., :d_rot], xf[..., d_rot:]
    return torch.cat([_apply_rot(head, cos, sin), tail], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0,
         rotary_pct: float = 1.0) -> torch.Tensor:
    """x ``[B, S, H, D]``, positions ``[B, S]`` -> rotated x (f32).

    ``rotary_pct < 1`` rotates only the leading fraction of each head
    (StableLM-style partial rotary)."""
    return apply_rope(x, rope_table(positions, x.shape[-1], theta=theta,
                                    rotary_pct=rotary_pct))


def mrope(x: torch.Tensor, positions: torch.Tensor, sections: tuple[int, int, int],
          *, theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x ``[B, S, H, D]``; positions ``[B, S, 3]``
    (t, h, w). The D/2 rotary frequencies are split into three contiguous
    sections that take their angle from the t/h/w position respectively."""
    return apply_rope(x, mrope_table(positions, x.shape[-1], sections, theta=theta))


# -- initialisers ----------------------------------------------------------------------


def init_dense(gen: torch.Generator | None, d_in: int, d_out: int, dtype: torch.dtype,
               *, scale: float | None = None) -> nn.Parameter:
    """A ``[d_in, d_out]`` weight: standard normal draws from ``gen`` (a
    CPU generator) times ``scale`` (default ``1/sqrt(d_in)``), in
    ``dtype``; left uninitialised when ``gen`` is None (the weights are
    then carried in, :func:`repro_torch.core.convert.lm_params_from_numpy`)."""
    if gen is None:
        return nn.Parameter(torch.empty((d_in, d_out), dtype=dtype), requires_grad=False)
    scale = scale if scale is not None else (1.0 / d_in) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=f32) * scale
    return nn.Parameter(w.to(dtype), requires_grad=False)


def init_zeros(d: int, dtype: torch.dtype) -> nn.Parameter:
    """A ``[d]`` parameter of zeros (biases, norm scales)."""
    return nn.Parameter(torch.zeros((d,), dtype=dtype), requires_grad=False)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), f32 at rest
    and initialised to 0 (the norms multiply by ``1 + scale``); applied by
    :func:`apply_norm`, f32 inside."""

    def __init__(self, kind: str, d: int):
        super().__init__()
        self.kind = kind
        self.scale = init_zeros(d, f32)
        self.bias = init_zeros(d, f32) if kind == "layernorm" else None


class MLP(nn.Module):
    """``w_gate``/``w_up``/``w_down`` (gated kinds) or ``w_up``/``w_down``,
    drawn in that order."""

    def __init__(self, gen: torch.Generator | None, kind: str, d_model: int, d_ff: int,
                 dtype: torch.dtype):
        super().__init__()
        self.kind = kind
        if kind in ("swiglu", "geglu"):
            self.w_gate = init_dense(gen, d_model, d_ff, dtype)
        self.w_up = init_dense(gen, d_model, d_ff, dtype)
        self.w_down = init_dense(gen, d_ff, d_model, dtype)

    def forward(self, x: torch.Tensor, act_to: torch.dtype | None = None) -> torch.Tensor:
        return mlp_apply(self.kind, x, self, act_to)
