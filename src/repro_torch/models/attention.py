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

__all__ = ["Attention", "attend", "init_kv_cache"]


class Attention(nn.Module):
    """Self-attention sublayer: ``wq``, ``wk``, ``wv``, ``wo`` (drawn in
    that order) and, with ``cfg.qkv_bias``, zero ``bq``/``bk``/``bv``;
    applied by :func:`attend`."""

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


def attend(p, x: torch.Tensor, qpos: torch.Tensor,
           rot: tuple[torch.Tensor, torch.Tensor] | None, *, window: int = -1,
           cache: dict | None = None, pos: int | None = None,
           act_to: torch.dtype | None = None, kv_runs: list | None = None):
    """The sublayer on the weights of ``p`` (an :class:`Attention`, or any
    object with its attributes: ``n_heads``, ``n_kv_heads``, ``head_dim``,
    ``wq``..``wo``, ``bq``/``bk``/``bv`` or None). x ``[B, S, D]`` (f32, or
    the activation dtype ``act_to``), qpos ``[B, S]`` int32 the queries'
    positions for the mask (the t position under M-RoPE), ``rot`` the
    forward's RoPE or M-RoPE table (None without rotary: the audio
    decoder's sinusoidal positions are in x already), ``window`` the local
    attention's width (-1: none). Without ``cache`` (train/prefill) the
    sequence attends causally to itself at key positions ``qpos[0]`` over
    its K/V upcast to f32 (exact). With ``cache`` (decode) S == 1: the KV
    pair is written into slot ``pos mod C`` (cast to the cache's dtype),
    whose ``cache["pos"]`` entry the caller has set to ``pos``, and the
    query attends over the cache, whatever order its slots' positions are
    in (a ring). Returns ``(out [B, S, D], (k, v))``, k ``[B, S, Hkv, Dh]``
    f32 after RoPE (the activation dtype without), v in the activation
    dtype. When the weights require grad the attention call carries its
    gradient (``ops.AttentionFn``).

    Under model-axis compute ``p`` is a rank's view: its query heads'
    columns of ``wq``/``bq`` and rows of ``wo`` (so the result is the
    rank's partial output, summed over the ranks by the caller), the KV
    heads they read, and ``n_heads``/``n_kv_heads`` set to those counts.
    Where its query heads do not fall into equal groups of one KV head
    each, ``kv_runs`` (``(q_lo, q_hi, kv)``, local indices) attends run by
    run, one attention call each, over the sequence or over the cache."""
    b, s, _ = x.shape
    q = dense(x, p.wq, p.bq, act_to).view(b, s, p.n_heads, p.head_dim)
    k = dense(x, p.wk, p.bk, act_to).view(b, s, p.n_kv_heads, p.head_dim)
    v = dense(x, p.wv, p.bv, act_to).view(b, s, p.n_kv_heads, p.head_dim)
    if rot is not None:
        q = apply_rope(q, rot)
        k = apply_rope(k, rot)
    q = q.to(torch.float32)
    if cache is not None:
        slot = pos % cache["k"].shape[1]
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        keys, values, kpos = cache["k"], cache["v"], cache["pos"]
    else:
        keys, values, kpos = k.to(torch.float32), v.to(torch.float32), qpos[0]
    if kv_runs is None:
        out = ops.attention(q, keys, values, qpos, kpos, window=window)
    else:
        out = torch.cat([ops.attention(q[:, :, lo:hi].contiguous(),
                                       keys[:, :, j:j + 1].contiguous(),
                                       values[:, :, j:j + 1].contiguous(), qpos, kpos,
                                       window=window)
                         for lo, hi, j in kv_runs], dim=2)
    proj = dense(out.reshape(b, s, p.n_heads * p.head_dim), p.wo, act_to=act_to)
    return proj, (k, v)


def init_kv_cache(cfg: ArchConfig, batch: int, capacity: int, dtype: torch.dtype,
                  device) -> dict:
    """One layer's empty KV cache of ``capacity`` slots."""
    shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((capacity,), -1, dtype=torch.int32, device=device)}
