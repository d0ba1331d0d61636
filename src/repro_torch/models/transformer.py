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

Training runs the same blocks on a parameter tree in the reference's
layout (``{"embed", "final_norm", "layers", "lm_head"}``, each ``layers``
leaf stacked ``[L, ...]``): :func:`params_view` gives it the model's
attributes, one unbound slice of each stacked leaf per layer, so the
gradient of a stacked leaf is one stack of the layers' gradients.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.network import _resolve_device, _unported
from repro_torch.models.attention import Attention, attend
from repro_torch.models.layers import MLP, Norm, act, apply_norm, dense, mlp_apply, rope_table
from repro_torch.precision import PrecisionPolicy

__all__ = ["Block", "Transformer", "init_params", "forward", "lm_logits", "init_cache",
           "decode_step", "params_tree", "params_view"]

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
    With ``gen`` None the weights are left uninitialised, to be carried in.
    The activation dtype is not the model's: the step functions pass their
    policy's (``act_to``)."""

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


def _norm(p, x: torch.Tensor, act_to) -> torch.Tensor:
    return act(apply_norm(p.kind, x, p), act_to)


def _block_full(layer, h, positions, rot, kv_cache: dict | None, act_to):
    """Full-sequence block (train/prefill) on ``layer`` (a :class:`Block`
    or a :func:`params_view` layer); packs its K/V into ``kv_cache`` (one
    layer's cache) when given."""
    x = _norm(layer.norm1, h, act_to)
    mix, kv = attend(layer.attn, x, positions, rot, act_to=act_to)
    if kv_cache is not None:
        _pack_kv(kv, positions, kv_cache)
    h = h + mix
    x = _norm(layer.norm2, h, act_to)
    return h + mlp_apply(layer.mlp.kind, x, layer.mlp, act_to)


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


def _block_decode(layer: Block, h, kv_cache: dict, positions, rot, pos: int, act_to):
    x = _norm(layer.norm1, h, act_to)
    h = h + attend(layer.attn, x, positions, rot, cache=kv_cache, pos=pos, act_to=act_to)[0]
    x = _norm(layer.norm2, h, act_to)
    return h + mlp_apply(layer.mlp.kind, x, layer.mlp, act_to)


def _layer_cache(cache: dict, i: int) -> dict:
    kv = cache["kv"]
    return {"k": kv["k"][i], "v": kv["v"][i], "pos": kv["pos"][i]}


def forward(model, batch: dict, *, collect_cache: bool = False, cache_len: int = 0,
            cache_dtype: torch.dtype = torch.float16, act_to: torch.dtype | None = None,
            remat: bool = False):
    """Train/prefill forward of ``model`` (a :class:`Transformer` or a
    :func:`params_view`) over ``batch["tokens"]`` ``[B, S]`` at
    ``batch["positions"]`` ``[B, S]`` int32 (the same row for every batch
    entry), activations in ``act_to`` (None: f32). Returns ``(h, aux)``:
    the final hidden states ``[B, S, D]`` in that dtype and the auxiliary
    loss (0.0 for the dense archs), and, with ``collect_cache``, the decode
    cache of ``cache_len`` slots in ``cache_dtype`` (:func:`init_cache`'s
    layout) as a third item. ``remat`` recomputes each block in the
    backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` over its layer scan."""
    cfg = model.cfg
    tokens, positions = batch["tokens"], batch["positions"]
    h = act(F.embedding(tokens, model.embed).to(f32), act_to)
    rot = _rope(cfg, positions)
    cache = None
    if collect_cache:
        cache = init_cache(cfg, tokens.shape[0], cache_len, cache_dtype, tokens.device)
    for i, layer in enumerate(model.layers):
        kv = _layer_cache(cache, i) if collect_cache else None
        if remat:
            h = checkpoint(_block_full, layer, h, positions, rot, kv, act_to,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _block_full(layer, h, positions, rot, kv, act_to)
    h = _norm(model.final_norm, h, act_to)
    aux = torch.zeros((), dtype=f32, device=h.device)
    return (h, aux, cache) if collect_cache else (h, aux)


def lm_logits(model: Transformer, h: torch.Tensor,
              act_to: torch.dtype | None = None) -> torch.Tensor:
    """h ``[.., D]`` -> logits ``[.., V]`` (f32 accumulate; in the
    activation dtype ``act_to``, as the reference's)."""
    w = model.embed.T if model.cfg.tie_embeddings else model.lm_head
    return dense(h, w, act_to=act_to)


def init_cache(cfg: ArchConfig, batch: int, capacity: int, dtype: torch.dtype,
               device) -> dict:
    """An empty decode cache of ``capacity`` slots for every layer."""
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    return {"kv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                   "v": torch.zeros(shape, dtype=dtype, device=device),
                   "pos": torch.full((cfg.n_layers, capacity), -1, dtype=torch.int32,
                                     device=device)}}


def decode_step(model: Transformer, cache: dict, token: torch.Tensor, pos: int,
                act_to: torch.dtype | None = None) -> tuple[torch.Tensor, dict]:
    """One serving step: token ``[B, 1]`` at position ``pos`` (a Python
    int, the same for the whole batch) -> ``(logits [B, V], cache)``, the
    logits in the activation dtype ``act_to``. The token's embedding stays f32, as
    the reference's decode step leaves it. The cache is updated in place
    (slot ``pos mod C`` of every layer) and returned."""
    cfg = model.cfg
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=token.device)
    h = F.embedding(token, model.embed).to(f32)
    rot = _rope(cfg, positions)
    kv = cache["kv"]
    kv["pos"][:, pos % kv["pos"].shape[1]] = pos
    for i, layer in enumerate(model.layers):
        h = _block_decode(layer, h, _layer_cache(cache, i), positions, rot, pos, act_to)
    h = _norm(model.final_norm, h, act_to)
    return lm_logits(model, h[:, 0], act_to), cache


# -- parameter trees (training) -------------------------------------------------------


def _norm_tree(p) -> dict:
    return {"scale": p.scale} if p.bias is None else {"scale": p.scale, "bias": p.bias}


def _layer_tree(layer: Block) -> dict:
    attn = {n: getattr(layer.attn, n) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
            if getattr(layer.attn, n) is not None}
    mlp = {n: getattr(layer.mlp, n) for n in ("w_gate", "w_up", "w_down")
           if hasattr(layer.mlp, n)}
    return {"norm1": _norm_tree(layer.norm1), "attn": attn, "norm2": _norm_tree(layer.norm2),
            "mlp": mlp}


def params_tree(model: Transformer) -> dict:
    """The model's parameters as the reference's tree (detached tensors):
    ``embed``, ``final_norm``, ``layers`` (each leaf stacked ``[L, ...]``)
    and, untied, ``lm_head``."""
    layers = [_layer_tree(layer) for layer in model.layers]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack([x.detach() for x in xs])

    tree = {"embed": model.embed.detach(), "final_norm": {
        k: v.detach() for k, v in _norm_tree(model.final_norm).items()},
        "layers": stack(*layers)}
    if model.lm_head is not None:
        tree["lm_head"] = model.lm_head.detach()
    return tree


def params_view(cfg: ArchConfig, params: dict) -> SimpleNamespace:
    """A :class:`Transformer`-shaped view of a parameter tree in the
    reference's layout (:func:`params_tree`), for :func:`forward` and
    :func:`lm_logits`: each stacked ``layers`` leaf is unbound once into
    its layers' slices, so autograd through the view reaches the tree's
    leaves."""
    def unbind(tree):
        if isinstance(tree, dict):
            return {k: unbind(v) for k, v in tree.items()}
        return tree.unbind(0)

    def norm(p: dict, i=None):
        pick = (lambda x: x) if i is None else (lambda x: x[i])
        return SimpleNamespace(kind=cfg.norm, scale=pick(p["scale"]),
                               bias=pick(p["bias"]) if "bias" in p else None)

    lay = unbind(params["layers"])
    layers = []
    for i in range(cfg.n_layers):
        attn = lay["attn"]
        layers.append(SimpleNamespace(
            norm1=norm(lay["norm1"], i), norm2=norm(lay["norm2"], i),
            attn=SimpleNamespace(
                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                **{n: attn[n][i] if n in attn else None
                   for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")}),
            mlp=SimpleNamespace(kind=cfg.mlp, **{n: w[i] for n, w in lay["mlp"].items()})))
    return SimpleNamespace(cfg=cfg, embed=params["embed"], lm_head=params.get("lm_head"),
                           final_norm=norm(params["final_norm"]), layers=layers)
