"""GQA attention with KV caches, on the hand-written attention kernel.

The reference's ``repro/models/attention.py`` runs ``chunked_attention``,
the XLA mirror of its Pallas ``flash_attention`` kernel. Here every
attention call goes through :func:`repro_torch.kernels.ops.attention`:
the CUDA kernel ``kernels/csrc/flash_attn.cu`` for tensors on the card,
its plain version ``kernels/ref.chunked_attention_ref`` on the CPU.

KV caches are held in the policy's state storage dtype (fp16 under the
paper's policy), ``[B, C, Hkv, Dh]`` with C the capacity and an int32
``pos`` per slot (-1 = empty). A decode step writes its KV pair into slot
``pos mod C`` in place (the reference returns a new cache).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense, init_dense, init_zeros

__all__ = ["Attention", "init_kv_cache"]


class Attention(nn.Module):
    """Self-attention sublayer: ``wq``, ``wk``, ``wv``, ``wo`` (drawn in
    that order) and, with ``cfg.qkv_bias``, zero ``bq``/``bk``/``bv``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, dtype: torch.dtype):
        super().__init__()
        self.n_heads, self.n_kv_heads, self.head_dim = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = init_dense(gen, cfg.d_model, cfg.q_dim, dtype)
        self.wk = init_dense(gen, cfg.d_model, cfg.kv_dim, dtype)
        self.wv = init_dense(gen, cfg.d_model, cfg.kv_dim, dtype)
        self.wo = init_dense(gen, cfg.q_dim, cfg.d_model, dtype)
        bias = cfg.qkv_bias
        self.bq = init_zeros(cfg.q_dim, dtype) if bias else None
        self.bk = init_zeros(cfg.kv_dim, dtype) if bias else None
        self.bv = init_zeros(cfg.kv_dim, dtype) if bias else None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                rot: tuple[torch.Tensor, torch.Tensor] | None, *,
                cache: dict | None = None, pos: int | None = None):
        """x ``[B, S, D]`` f32, positions ``[B, S]`` int32, ``rot`` the
        forward's RoPE table (None without rotary). Without ``cache``
        (train/prefill) the sequence attends causally to itself over its
        f32 K/V. With ``cache`` (decode) S == 1: the KV pair is written into
        slot ``pos mod C``, whose ``cache["pos"]`` entry the caller has set
        to ``pos``, and the query attends over the cache. Returns ``(out
        [B, S, D], (k, v))``, k/v ``[B, S, Hkv, Dh]`` f32 after RoPE."""
        b, s, _ = x.shape
        q = dense(x, self.wq, self.bq).view(b, s, self.n_heads, self.head_dim)
        k = dense(x, self.wk, self.bk).view(b, s, self.n_kv_heads, self.head_dim)
        v = dense(x, self.wv, self.bv).view(b, s, self.n_kv_heads, self.head_dim)
        if rot is not None:
            q = apply_rope(q, rot)
            k = apply_rope(k, rot)
        if cache is not None:
            slot = pos % cache["k"].shape[1]
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            out = ops.attention(q, cache["k"], cache["v"], positions, cache["pos"])
        else:
            out = ops.attention(q, k, v, positions, positions[0])
        proj = dense(out.reshape(b, s, self.n_heads * self.head_dim), self.wo)
        return proj, (k, v)


def init_kv_cache(cfg: ArchConfig, batch: int, capacity: int, dtype: torch.dtype,
                  device) -> dict:
    """One layer's empty KV cache of ``capacity`` slots."""
    shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((capacity,), -1, dtype=torch.int32, device=device)}
