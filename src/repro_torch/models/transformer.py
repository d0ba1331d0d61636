"""Config-driven decoder for the dense GQA transformers.

Mirrors the reference's ``repro/models/transformer.py`` for
``family="dense"`` (qwen2.5, minitron, smollm, stablelm): token embedding,
``n_layers`` pre-norm blocks (attention, then MLP, each added to the
residual), final norm, logits through the LM head or the tied embedding.
The layers run in a Python loop; the model is an ``nn.Module`` whose
parameters sit in the policy's storage dtype (norm scales in f32), as the
reference's parameter tree does. The reference's MoE, SSM, RG-LRU hybrid,
audio (sinusoidal positions) and VLM branches raise
``NotImplementedError`` (ROADMAP A12).

The decode cache is the reference's layout for a homogeneous stack:
``{"kv": {"k", "v": [L, B, C, Hkv, Dh], "pos": [L, C]}}``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.core.network import _resolve_device, _unported
from repro_torch.models.attention import Attention
from repro_torch.models.layers import MLP, Norm, apply_norm, dense, rope_table
from repro_torch.precision import PrecisionPolicy

__all__ = ["Block", "Transformer", "init_params", "forward", "lm_logits", "init_cache",
           "decode_step"]

f32 = torch.float32


def _check_ported(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.moe is not None or cfg.ssm is not None \
            or cfg.hybrid is not None:
        raise _unported(f"the {cfg.family!r} family", "A12")
    if cfg.frontend != "none":
        raise _unported(f"the {cfg.frontend!r} frontend", "A12")
    if cfg.mrope_sections is not None:
        raise _unported("M-RoPE positions", "A12")
    if cfg.rotary_pct == 0.0:
        raise _unported("sinusoidal positions (rotary_pct=0)", "A12")


class Block(nn.Module):
    """Pre-norm block: ``norm1``, ``attn``, ``norm2``, ``mlp``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator | None, dtype: torch.dtype):
        super().__init__()
        self.norm1 = Norm(cfg.norm, cfg.d_model)
        self.attn = Attention(cfg, gen, dtype)
        self.norm2 = Norm(cfg.norm, cfg.d_model)
        self.mlp = MLP(gen, cfg.mlp, cfg.d_model, cfg.d_ff, dtype)


class Transformer(nn.Module):
    """``embed`` ``[V, D]``, ``layers`` (``n_layers`` :class:`Block`),
    ``final_norm`` and, untied, ``lm_head`` ``[D, V]``. Weights are
    standard normal draws from a CPU generator, in this order: embed,
    lm_head, then per layer wq, wk, wv, wo and the MLP's weights; scaled
    by ``1/sqrt(fan-in)`` (embed and lm_head by ``1/sqrt(d_model)``).
    With ``gen`` None the weights are left uninitialised, to be carried in."""

    def __init__(self, cfg: ArchConfig, policy: PrecisionPolicy,
                 gen: torch.Generator | None):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        dtype = policy.param_storage
        scale = (1.0 / cfg.d_model) ** 0.5

        def draw(shape):
            if gen is None:
                return nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)
            w = torch.randn(shape, generator=gen, dtype=f32) * scale
            return nn.Parameter(w.to(dtype), requires_grad=False)

        self.embed = draw((cfg.vocab_size, cfg.d_model))
        self.lm_head = None if cfg.tie_embeddings else draw((cfg.d_model, cfg.vocab_size))
        self.layers = nn.ModuleList(Block(cfg, gen, dtype) for _ in range(cfg.n_layers))
        self.final_norm = Norm(cfg.norm, cfg.d_model)


def init_params(cfg: ArchConfig, policy: PrecisionPolicy, *, seed: int = 0,
                device=None) -> Transformer:
    """A randomly initialised model on ``device`` (None: the card, raising
    without one). The draws come from a CPU ``torch.Generator`` seeded with
    ``seed``, so every device holds the same weights."""
    device = _resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return Transformer(cfg, policy, gen).to(device)


def _rope(cfg: ArchConfig, positions: torch.Tensor):
    return rope_table(positions, cfg.head_dim, theta=cfg.rope_theta,
                      rotary_pct=cfg.rotary_pct)


def _block_full(layer: Block, h, positions, rot, cfg: ArchConfig, kv_cache: dict | None):
    """Full-sequence block (train/prefill); packs its K/V into ``kv_cache``
    (one layer's cache) when given."""
    x = apply_norm(cfg.norm, h, layer.norm1)
    mix, kv = layer.attn(x, positions, rot)
    if kv_cache is not None:
        _pack_kv(kv, positions, kv_cache)
    h = h + mix
    x = apply_norm(cfg.norm, h, layer.norm2)
    return h + layer.mlp(x)


def _pack_kv(kv, positions: torch.Tensor, kv_cache: dict) -> None:
    """Write full-sequence ``(k, v)`` ``[B, S, Hkv, Dh]`` into the first S
    slots of an empty decode cache (cast to its dtype), with their
    positions; the other slots stay empty (``pos = -1``)."""
    k, v = kv
    s = k.shape[1]
    if s > kv_cache["k"].shape[1]:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{kv_cache['k'].shape[1]} slots")
    kv_cache["k"][:, :s] = k
    kv_cache["v"][:, :s] = v
    kv_cache["pos"][:s] = positions[0]


def _block_decode(layer: Block, h, kv_cache: dict, positions, rot, cfg: ArchConfig,
                  pos: int):
    x = apply_norm(cfg.norm, h, layer.norm1)
    h = h + layer.attn(x, positions, rot, cache=kv_cache, pos=pos)[0]
    x = apply_norm(cfg.norm, h, layer.norm2)
    return h + layer.mlp(x)


def _layer_cache(cache: dict, i: int) -> dict:
    kv = cache["kv"]
    return {"k": kv["k"][i], "v": kv["v"][i], "pos": kv["pos"][i]}


def forward(model: Transformer, batch: dict, *, collect_cache: bool = False,
            cache_len: int = 0, cache_dtype: torch.dtype = torch.float16):
    """Train/prefill forward over ``batch["tokens"]`` ``[B, S]`` at
    ``batch["positions"]`` ``[B, S]`` int32 (the same row for every batch
    entry). Returns the final hidden states ``[B, S, D]`` f32 and, with
    ``collect_cache``, the decode cache of ``cache_len`` slots in
    ``cache_dtype`` (:func:`init_cache`'s layout)."""
    cfg = model.cfg
    tokens, positions = batch["tokens"], batch["positions"]
    h = model.embed[tokens].to(f32)
    rot = _rope(cfg, positions)
    cache = None
    if collect_cache:
        cache = init_cache(cfg, tokens.shape[0], cache_len, cache_dtype, tokens.device)
    for i, layer in enumerate(model.layers):
        h = _block_full(layer, h, positions, rot, cfg,
                        _layer_cache(cache, i) if collect_cache else None)
    h = apply_norm(cfg.norm, h, model.final_norm)
    return (h, cache) if collect_cache else h


def lm_logits(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    """h ``[.., D]`` -> logits ``[.., V]`` (f32 accumulate)."""
    w = model.embed.T if model.cfg.tie_embeddings else model.lm_head
    return dense(h, w)


def init_cache(cfg: ArchConfig, batch: int, capacity: int, dtype: torch.dtype,
               device) -> dict:
    """An empty decode cache of ``capacity`` slots for every layer."""
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device),
                   "pos": torch.full((cfg.n_layers, capacity), -1, dtype=torch.int32,
                                     device=device)}}


def decode_step(model: Transformer, cache: dict, token: torch.Tensor,
                pos: int) -> tuple[torch.Tensor, dict]:
    """One serving step: token ``[B, 1]`` at position ``pos`` (a Python
    int, the same for the whole batch) -> ``(logits [B, V] f32, cache)``.
    The cache is updated in place (slot ``pos mod C`` of every layer) and
    returned."""
    cfg = model.cfg
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=token.device)
    h = model.embed[token].to(f32)
    rot = _rope(cfg, positions)
    kv = cache["kv"]
    kv["pos"][:, pos % kv["pos"].shape[1]] = pos
    for i, layer in enumerate(model.layers):
        h = _block_decode(layer, h, _layer_cache(cache, i), positions, rot, cfg, pos)
    h = apply_norm(cfg.norm, h, model.final_norm)
    return lm_logits(model, h[:, 0]), cache
