"""Config-driven decoder for all ten architectures
(``repro/models/transformer.py``).

One generic decoder covering the dense GQA transformers (qwen2.5,
minitron, smollm, stablelm), MoE (granite, qwen2-moe: :mod:`.moe` in
place of the MLP, the load-balance loss summed over layers), the pure
SSM (falcon-mamba: a block is norm and :mod:`.mamba` mixer only), the
RG-LRU hybrid (recurrentgemma: :mod:`.rglru` layers and every third a
local-attention layer with a window), the audio-token decoder (musicgen:
sinusoidal positions added to the embeddings, no rotary) and the VLM
(qwen2-vl: M-RoPE and the batch's patch embeddings as a prefix). The
layers run in a Python loop; the model is an ``nn.Module`` whose
parameters sit in the policy's storage dtype (norm scales and the SSM's
and RG-LRU's f32 leaves as the reference keeps them).

Decode caches are the reference's layouts. A homogeneous stack stacks
each layer's entry: ``{"kv": {"k", "v": [L, B, C, Hkv, Dh], "pos": [L,
C]}}`` or ``{"ssm": {"conv": [L, B, K-1, Di], "ssm": [L, B, Di, N]}}``.
The hybrid's is a tuple of per-layer entries, ``{"kv": ...}`` (capacity
capped at the window: a ring, slot ``pos mod C``) or ``{"rglru": {"h":
[B, W], "conv": [B, 3, W]}}``.

Training runs the same blocks on a parameter tree in the reference's
layout (``{"embed", "final_norm", "layers", "lm_head"}``; ``layers`` a
dict of leaves stacked ``[L, ...]`` for a homogeneous stack, a tuple of
per-layer dicts for the hybrid): :func:`params_view` gives it the
model's attributes, one unbound slice of each stacked leaf per layer, so
the gradient of a stacked leaf is one stack of the layers' gradients.

**Over a model group** (the mesh lowering's model-axis compute,
``models/tasks.py``), :func:`forward_group` runs the same blocks on each
rank's view (:func:`params_view` with the rank's heads) of its ranges of
the parameters (``launch/mesh.compute_plan``): the vocab-parallel
embedding (each rank looks up its vocab range, out-of-range rows zero,
the parts summed), column-parallel ``wq``/``wk``/``wv`` and
``w_gate``/``w_up``, row-parallel ``wo`` and ``w_down`` whose partial
outputs are summed over the group in rank order
(``launch/sharded.group_sum``, Megatron's g), the MoE over its experts
(:func:`repro_torch.models.moe.moe_group`), Mamba and the RG-LRU over
their channels (``mamba_group``, ``rglru_group``), and the vocab-parallel
logits (:func:`lm_logits_group`); :func:`decode_group` is its one-token
step (the ranks' shares of each layer's cache handed in and back, Mamba's
and the RG-LRU's ``mamba_decode_group``, ``rglru_decode_group``). With
``seq_shard`` the residual stream between blocks is each rank's
contiguous sequence range (Megatron's sequence parallelism): the norms run
on that range, an all-gather along the sequence precedes the
column-parallel projections and a reduce-scatter follows the row-parallel
ones (``seq_gather`` / ``seq_scatter``), and remat saves only the range.
Without it every rank holds the whole stream and runs the norms range by
range too (its own range alone takes the norm scales' gradient), then
Megatron's f: every sum runs in the same rank order either way, so the two
give the same bits.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.network import _resolve_device
from repro_torch.launch import sharded as sh
from repro_torch.models.attention import Attention, attend, init_kv_cache
from repro_torch.models.layers import (
    MLP, Norm, act, apply_norm, dense, mlp_apply, mrope_table, rope_table,
)
from repro_torch.models.mamba import (
    Mamba, init_mamba_cache, mamba_apply, mamba_decode_group, mamba_decode_step, mamba_group,
)
from repro_torch.models.moe import MoE, moe_apply, moe_group
from repro_torch.models.rglru import (
    RGLRU, init_rglru_cache, rglru_apply, rglru_decode_group, rglru_decode_step, rglru_group,
)
from repro_torch.precision import PrecisionPolicy

__all__ = ["Block", "Transformer", "init_params", "forward", "aux_loss", "lm_logits", "init_cache",
           "decode_step", "params_tree", "params_view", "GroupRun", "forward_group",
           "lm_logits_group", "decode_group"]

f32 = torch.float32


class Block(nn.Module):
    """Pre-norm block of kind ``kind``: ``norm1`` and the mixer (``attn``,
    ``ssm`` or ``rglru``), then, but for a Mamba block, ``norm2`` and the
    ``mlp`` (or the ``moe``)."""

    def __init__(self, cfg: ArchConfig, kind: str, gen: torch.Generator | None,
                 dtype: torch.dtype):
        super().__init__()
        self.norm1 = Norm(cfg.norm, cfg.d_model)
        if kind == "attn":
            self.attn = Attention(cfg, gen, dtype)
        elif kind == "ssm":
            self.ssm = Mamba(cfg, gen, dtype)
            return
        else:
            self.rglru = RGLRU(cfg, gen, dtype)
        self.norm2 = Norm(cfg.norm, cfg.d_model)
        if cfg.moe is not None:
            self.moe = MoE(cfg, gen, dtype)
        else:
            self.mlp = MLP(gen, cfg.mlp, cfg.d_model, cfg.d_ff, dtype)


class Transformer(nn.Module):
    """``embed`` ``[V, D]``, ``layers`` (``n_layers`` :class:`Block`, each
    of ``cfg.layer_kind(i)``), ``final_norm`` and, untied, ``lm_head`` ``[D,
    V]``. Weights are standard normal draws from a CPU generator, in this
    order: embed, lm_head, then layer by layer in each block's order; scaled
    by ``1/sqrt(fan-in)`` (embed and lm_head by ``1/sqrt(d_model)``). With
    ``gen`` None the weights are left uninitialised, to be carried in. The
    activation dtype is not the model's: the step functions pass their
    policy's (``act_to``)."""

    def __init__(self, cfg: ArchConfig, policy: PrecisionPolicy,
                 gen: torch.Generator | None):
        super().__init__()
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
        self.layers = nn.ModuleList(Block(cfg, cfg.layer_kind(i), gen, dtype)
                                    for i in range(cfg.n_layers))
        self.final_norm = Norm(cfg.norm, cfg.d_model)


def init_params(cfg: ArchConfig, policy: PrecisionPolicy, *, seed: int = 0,
                device=None) -> Transformer:
    """A randomly initialised model on ``device`` (None: the card, raising
    without one). The draws come from a CPU ``torch.Generator`` seeded with
    ``seed``, so every device holds the same weights. On ``"meta"`` the
    same modules hold empty tensors of their shapes and dtypes (the
    dry-run's and the plan's trees: nothing is drawn or allocated)."""
    device = _resolve_device(device)
    if device.type == "meta":  # shapes and dtypes only: the same modules, nothing drawn
        with torch.device("meta"):
            return Transformer(cfg, policy, None)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return Transformer(cfg, policy, gen).to(device)


def _window(cfg: ArchConfig) -> int:
    return cfg.hybrid.window if cfg.hybrid is not None else -1


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """positions ``[B, S]`` -> ``[B, S, d]`` f32 (musicgen's absolute
    positions): ``sin`` then ``cos`` of ``pos * exp(-log(1e4) i / (d/2))``."""
    half = d // 2
    log10k = torch.log(torch.tensor(10000.0, dtype=f32, device=positions.device))
    freqs = torch.exp(-log10k * torch.arange(half, dtype=f32, device=positions.device) / half)
    ang = positions.to(f32)[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _Ctx(SimpleNamespace):
    """What every block of one forward or decode step shares: ``qpos``
    (``[B, S]`` int32, the mask's positions), ``rot`` (the RoPE or M-RoPE
    table, or None), ``window`` and ``act_to``."""


def _ctx(cfg: ArchConfig, positions: torch.Tensor, act_to) -> _Ctx:
    if cfg.mrope_sections is not None:
        rot = mrope_table(positions, cfg.head_dim, cfg.mrope_sections, theta=cfg.rope_theta)
        qpos = positions[..., 0].contiguous()
    elif cfg.rotary_pct > 0:
        rot = rope_table(positions, cfg.head_dim, theta=cfg.rope_theta,
                         rotary_pct=cfg.rotary_pct)
        qpos = positions
    else:
        rot, qpos = None, positions
    return _Ctx(qpos=qpos, rot=rot, window=_window(cfg), act_to=act_to)


def _norm(p, x: torch.Tensor, act_to) -> torch.Tensor:
    return act(apply_norm(p.kind, x, p), act_to)


def _ffn(layer, h, cfg: ArchConfig, ctx: _Ctx):
    """The residual's second half: ``h + mlp(norm2(h))`` (or the MoE's),
    and the layer's load-balance loss (None without MoE)."""
    x = _norm(layer.norm2, h, ctx.act_to)
    if cfg.moe is not None:
        y, aux = moe_apply(layer.moe, x, cfg, ctx.act_to)
        return h + y, aux
    return h + mlp_apply(cfg.mlp, x, layer.mlp, ctx.act_to), None


def _block_full(layer, h, cfg: ArchConfig, kind: str, ctx: _Ctx, cache: dict | None):
    """Full-sequence block (train/prefill) on ``layer`` (a :class:`Block`
    or a :func:`params_view` layer). Fills ``cache`` (the layer's entry of
    the prefill cache) when given. Returns ``(h, aux)``, aux None without
    MoE."""
    x = _norm(layer.norm1, h, ctx.act_to)
    if kind == "attn":
        mix, kv = attend(layer.attn, x, ctx.qpos, ctx.rot, window=ctx.window,
                         act_to=ctx.act_to)
        if cache is not None:
            _pack_kv(kv, ctx.qpos[0], ctx.window, cache["kv"])
    elif kind == "ssm":
        mix, st = mamba_apply(layer.ssm, x, cfg, ctx.act_to, return_state=cache is not None)
        if cache is not None:
            _copy_state(cache["ssm"], st)
        return h + mix, None
    else:
        mix, st = rglru_apply(layer.rglru, x, cfg, ctx.act_to, return_state=cache is not None)
        if cache is not None:
            _copy_state(cache["rglru"], st)
    return _ffn(layer, h + mix, cfg, ctx)


def _copy_state(dst: dict, src: dict) -> None:
    for name, x in src.items():
        dst[name].copy_(x)


def _pack_kv(kv, pos: torch.Tensor, window: int, kv_cache: dict) -> None:
    """Write full-sequence ``(k, v)`` ``[B, S, Hkv, Dh]`` at positions
    ``pos`` ``[S]`` into an empty decode cache of C slots (cast to its
    dtype), as the reference's ``_pack_kv``: with a local window and ``C <=
    window`` as a ring (the last ``min(C, S)`` tokens, slot ``pos mod C``),
    else into the first S slots; the other slots stay empty (``pos =
    -1``)."""
    k, v = kv
    s, cap = k.shape[1], kv_cache["k"].shape[1]
    if window > 0 and cap <= window:
        keep = min(cap, s)
        k, v, pos = k[:, s - keep:], v[:, s - keep:], pos[s - keep:]
        slots = torch.remainder(pos, cap).long()
        kv_cache["k"][:, slots] = k.to(kv_cache["k"].dtype)
        kv_cache["v"][:, slots] = v.to(kv_cache["v"].dtype)
        kv_cache["pos"][slots] = pos
        return
    if s > cap:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of {cap} slots")
    kv_cache["k"][:, :s] = k
    kv_cache["v"][:, :s] = v
    kv_cache["pos"][:s] = pos


def _block_decode(layer, h, cfg: ArchConfig, kind: str, ctx: _Ctx, cache: dict, pos: int):
    x = _norm(layer.norm1, h, ctx.act_to)
    if kind == "attn":
        mix = attend(layer.attn, x, ctx.qpos, ctx.rot, window=ctx.window, cache=cache["kv"],
                     pos=pos, act_to=ctx.act_to)[0]
    elif kind == "ssm":
        return h + mamba_decode_step(layer.ssm, x, cache["ssm"], cfg, ctx.act_to)
    else:
        mix = rglru_decode_step(layer.rglru, x, cache["rglru"], cfg, ctx.act_to)
    return _ffn(layer, h + mix, cfg, ctx)[0]


def _layer_cache(cfg: ArchConfig, cache, i: int) -> dict:
    """Layer ``i``'s entry of a cache: the tuple's item, or views of row
    ``i`` of each stacked tensor (writes reach the stack)."""
    if not cfg.homogeneous:
        return cache[i]
    return {part: {name: t[i] for name, t in entry.items()} for part, entry in cache.items()}


def _embed_inputs(model, batch: dict, act_to):
    """``(h [B, S, D], positions)``: the token embeddings (in the activation
    dtype), behind the batch's ``patch_embeds`` under the vision frontend,
    plus sinusoidal positions without rotary. The concatenation with the f32
    patches and the sum with the f32 sinusoids promote h to f32, as the
    reference's ``jnp`` promotion does."""
    cfg = model.cfg
    h = act(F.embedding(batch["tokens"], model.embed).to(f32), act_to)
    if cfg.frontend == "vision":
        h = torch.cat([batch["patch_embeds"].to(f32), h], dim=1)
    positions = batch["positions"]
    if cfg.rotary_pct == 0.0 and cfg.mrope_sections is None:
        h = h + _sinusoidal(positions, cfg.d_model)
    return h, positions


def _assemble(cfg: ArchConfig, caches: list):
    if not cfg.homogeneous:
        return tuple(caches)
    return {part: {name: torch.stack([c[part][name] for c in caches])
                   for name in caches[0][part]} for part in caches[0]}


def forward(model, batch: dict, *, collect_cache: bool = False, cache_len: int = 0,
            cache_dtype: torch.dtype = torch.float16, act_to: torch.dtype | None = None,
            remat: bool = False):
    """Train/prefill forward of ``model`` (a :class:`Transformer` or a
    :func:`params_view`) over ``batch["tokens"]`` ``[B, S]`` (behind
    ``batch["patch_embeds"]`` ``[B, P, D]`` under the vision frontend) at
    ``batch["positions"]`` (``[B, S + P]`` int32, the same row for every
    batch entry; ``[B, S + P, 3]`` under M-RoPE), activations in ``act_to``
    (None: f32). Returns ``(h, aux)``: the final hidden states in that dtype
    and the load-balance loss summed over the MoE layers (0.0 without), and,
    with ``collect_cache``, the decode cache of ``cache_len`` slots in
    ``cache_dtype`` as a third item. ``remat`` recomputes each block in the
    backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` does."""
    cfg = model.cfg
    h, positions = _embed_inputs(model, batch, act_to)
    ctx = _ctx(cfg, positions, act_to)
    cache = None
    if collect_cache:
        cache = init_cache(cfg, h.shape[0], cache_len, cache_dtype, h.device,
                           cap_at_window=False)
    aux = torch.zeros((), dtype=f32, device=h.device)
    for i, layer in enumerate(model.layers):
        kind = cfg.layer_kind(i)
        lc = _layer_cache(cfg, cache, i) if collect_cache else None
        if remat:
            h, a = checkpoint(_block_full, layer, h, cfg, kind, ctx, lc, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            h, a = _block_full(layer, h, cfg, kind, ctx, lc)
        if a is not None:
            aux = aux + a
    h = _norm(model.final_norm, h, act_to)
    return (h, aux, cache) if collect_cache else (h, aux)


def aux_loss(cfg: ArchConfig, stats: list, device) -> torch.Tensor:
    """The load-balance loss summed over the MoE layers from their routing
    statistics (:func:`forward_group`'s: per layer ``[frac, mean_prob]``
    ``[2, E]``), as each layer's ``moe_apply`` computes it. The mesh
    lowering averages the statistics over its data indices first: the loss
    is not additive over rows."""
    aux = torch.zeros((), dtype=f32, device=device)
    for st in stats:
        aux = aux + cfg.moe.n_experts * torch.sum(st[0] * st[1])
    return aux


def lm_logits(model: Transformer, h: torch.Tensor,
              act_to: torch.dtype | None = None) -> torch.Tensor:
    """h ``[.., D]`` -> logits ``[.., V]`` (f32 accumulate; in the
    activation dtype ``act_to``, as the reference's)."""
    w = model.embed.T if model.cfg.tie_embeddings else model.lm_head
    return dense(h, w, act_to=act_to)


def init_cache(cfg: ArchConfig, batch: int, capacity: int, dtype: torch.dtype, device, *,
               cap_at_window: bool = True):
    """An empty decode cache of ``capacity`` slots: the stacked layout of a
    homogeneous stack, a tuple of per-layer entries for the hybrid, whose
    attention layers hold ``min(capacity, window)`` slots (a ring). The
    prefill's cache passes ``cap_at_window=False``: every attention layer
    holds ``capacity`` slots (a ring only where ``capacity`` is within the
    window), as the reference's ``_pack_kv`` sizes it."""
    def layer(i: int):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            cap = capacity
            if cap_at_window and cfg.hybrid is not None:
                cap = min(capacity, cfg.hybrid.window)
            return {"kv": init_kv_cache(cfg, batch, cap, dtype, device)}
        if kind == "ssm":
            return {"ssm": init_mamba_cache(cfg, batch, dtype, device)}
        return {"rglru": init_rglru_cache(cfg, batch, dtype, device)}

    return _assemble(cfg, [layer(i) for i in range(cfg.n_layers)])


def decode_step(model: Transformer, cache, token: torch.Tensor, pos: int,
                act_to: torch.dtype | None = None):
    """One serving step: token ``[B, 1]`` at position ``pos`` (a Python
    int, the same for the whole batch; all three M-RoPE positions under the
    VLM) -> ``(logits [B, V], cache)``, the logits in the activation dtype
    ``act_to``. The token's embedding stays f32, as the reference's decode
    step leaves it (decode sees no modality prefix). The cache is updated
    in place (every attention layer's slot ``pos mod C``, every recurrent
    layer's state) and returned."""
    cfg = model.cfg
    b = token.shape[0]
    shape = (b, 1, 3) if cfg.mrope_sections is not None else (b, 1)
    positions = torch.full(shape, pos, dtype=torch.int32, device=token.device)
    h = F.embedding(token, model.embed).to(f32)
    if cfg.rotary_pct == 0.0 and cfg.mrope_sections is None:
        h = h + _sinusoidal(positions, cfg.d_model)
    ctx = _ctx(cfg, positions, act_to)
    for i, layer in enumerate(model.layers):
        kind = cfg.layer_kind(i)
        lc = _layer_cache(cfg, cache, i)
        if kind == "attn":
            kv = lc["kv"]
            kv["pos"][pos % kv["pos"].shape[0]] = pos
        h = _block_decode(layer, h, cfg, kind, ctx, lc, pos)
    h = _norm(model.final_norm, h, act_to)
    return lm_logits(model, h[:, 0], act_to), cache


# -- parameter trees (training) -------------------------------------------------------


def _tree(module: nn.Module | None) -> dict:
    """A block's (or sublayer's) parameters as the reference's nested dict."""
    out = {}
    for name, p in module.named_parameters(recurse=False):
        out[name] = p.detach()
    for name, child in module.named_children():
        out[name] = _tree(child)
    return out


def params_tree(model: Transformer) -> dict:
    """The model's parameters as the reference's tree (detached tensors):
    ``embed``, ``final_norm``, ``layers`` (each leaf stacked ``[L, ...]``,
    or a tuple of per-layer dicts for the hybrid) and, untied,
    ``lm_head``."""
    layers = [_tree(layer) for layer in model.layers]

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)

    tree = {"embed": model.embed.detach(), "final_norm": _tree(model.final_norm),
            "layers": stack(*layers) if model.cfg.homogeneous else tuple(layers)}
    if model.lm_head is not None:
        tree["lm_head"] = model.lm_head.detach()
    return tree


def _norm_view(cfg: ArchConfig, p: dict) -> SimpleNamespace:
    return SimpleNamespace(kind=cfg.norm, scale=p["scale"], bias=p.get("bias"))


def _layer_view(cfg: ArchConfig, lay: dict, heads: tuple[int, int] | None = None
                ) -> SimpleNamespace:
    n_heads, n_kv = heads if heads is not None else (cfg.n_heads, cfg.n_kv_heads)
    out = {}
    for name, sub in lay.items():
        if name in ("norm1", "norm2"):
            out[name] = _norm_view(cfg, sub)
        elif name == "attn":
            out[name] = SimpleNamespace(
                n_heads=n_heads, n_kv_heads=n_kv, head_dim=cfg.head_dim,
                **{n: sub.get(n) for n in ("wq", "wk", "wv", "wo", "bq", "bk", "bv")})
        elif name == "mlp":
            out[name] = SimpleNamespace(kind=cfg.mlp, **sub)
        elif name == "moe":
            shared = sub.get("shared")
            out[name] = SimpleNamespace(
                **{n: w for n, w in sub.items() if n != "shared"},
                shared=None if shared is None else SimpleNamespace(kind=cfg.mlp, **shared))
        else:  # ssm, rglru: flat leaves
            out[name] = SimpleNamespace(**sub)
    return SimpleNamespace(**out)


def params_view(cfg: ArchConfig, params: dict, heads: tuple[int, int] | None = None
                ) -> SimpleNamespace:
    """A :class:`Transformer`-shaped view of a parameter tree in the
    reference's layout (:func:`params_tree`), for :func:`forward` and
    :func:`lm_logits`: each stacked ``layers`` leaf is unbound once into
    its layers' slices (a hybrid's tuple is taken layer by layer), so
    autograd through the view reaches the tree's leaves. ``heads`` (query,
    KV) sets the attention's head counts: a model rank's tree of its
    ranges (:func:`forward_group`)."""
    lay = params["layers"]
    if isinstance(lay, dict):
        def unbind(tree):
            if isinstance(tree, dict):
                return {k: unbind(v) for k, v in tree.items()}
            return tree.unbind(0)

        def pick(tree, i):
            if isinstance(tree, dict):
                return {k: pick(v, i) for k, v in tree.items()}
            return tree[i]

        parts = unbind(lay)
        per_layer = [pick(parts, i) for i in range(cfg.n_layers)]
    else:
        per_layer = list(lay)
    return SimpleNamespace(cfg=cfg, embed=params["embed"], lm_head=params.get("lm_head"),
                           final_norm=_norm_view(cfg, params["final_norm"]),
                           layers=[_layer_view(cfg, p, heads) for p in per_layer])


# -- model-axis compute over a model group ------------------------------------------------


class GroupRun(SimpleNamespace):
    """One data index's model group under model-axis compute: ``grp`` (its
    :class:`~repro_torch.launch.sharded.Group`), ``plan`` (each rank's
    :class:`~repro_torch.launch.mesh.RankPlan`), ``seq`` (each rank's
    sequence range of the whole sequence, prefix included), ``seq_shard``,
    ``act_to``, ``kv_runs`` (per rank: None, or the runs a rank whose
    query heads split unevenly over its KV heads attends by)."""

    def reduce(self, parts: list) -> list:
        """The ranks' partial outputs (None: nothing from that rank) summed
        over the group in rank order: each rank's sequence range of the sum
        (``seq_shard``) or all of it."""
        if self.seq_shard:
            return sh.seq_scatter(self.grp, parts, self.seq)
        return sh.group_sum(self.grp, parts)

    def spread(self, own: list) -> list:
        """The ranks' outputs over their own sequence ranges in the residual
        stream's layout: as they are under ``seq_shard``, else each range
        zero-padded and the ranges summed onto every rank (each element
        one nonzero part: exact; each range takes its own rank's
        cotangent, as Megatron's g hands it)."""
        if self.seq_shard:
            return own
        s = self.seq[-1][1]
        parts = []
        for r, (y, (lo, hi)) in enumerate(zip(own, self.seq)):
            with self.grp.on(r):
                parts.append(F.pad(y, (0, 0, lo, s - hi)))
        return sh.group_sum(self.grp, parts)


def _vocab_lookup(view, t: torch.Tensor, vocab: tuple[int, int]) -> torch.Tensor:
    """The rows of ``t``'s tokens in a rank's vocab range of the embedding,
    zero for tokens outside it (the whole lookup when the range is the
    vocab), in the storage dtype."""
    lo, hi = vocab
    if (lo, hi) == (0, view.cfg.vocab_size):
        return F.embedding(t, view.embed)
    inside = (t >= lo) & (t < hi)
    e = F.embedding(torch.where(inside, t - lo, 0), view.embed)
    return torch.where(inside[..., None], e, torch.zeros((), dtype=e.dtype, device=e.device))


def _embed_part(view, batch: dict, vocab: tuple[int, int], act_to, first: bool):
    """Rank's share of the embedded inputs: its vocab range's rows
    (:func:`_vocab_lookup`), and the patch prefix on the first rank (zeros
    on the others)."""
    cfg = view.cfg
    h = act(_vocab_lookup(view, batch["tokens"], vocab).to(f32), act_to)
    if cfg.frontend == "vision":
        patches = batch["patch_embeds"].to(f32)
        h = torch.cat([patches if first else torch.zeros_like(patches), h], dim=1)
    return h


def _group_embed(views: list, batches: list, run: GroupRun) -> list:
    """:func:`_embed_inputs` over the group: the vocab-parallel lookup's
    parts summed (each element has one nonzero part: exact), then the
    sinusoids of the whole sequence, sliced to a rank's range."""
    cfg = views[0].cfg
    parts = []
    for r, (v, b) in enumerate(zip(views, batches)):
        with run.grp.on(r):
            parts.append(_embed_part(v, b, run.plan[r].vocab, run.act_to, r == 0))
    hs = run.reduce(parts)
    if cfg.rotary_pct == 0.0 and cfg.mrope_sections is None:
        out = []
        for r, (h, b) in enumerate(zip(hs, batches)):
            with run.grp.on(r):
                sin = _sinusoidal(b["positions"], cfg.d_model)
                lo, hi = run.seq[r] if run.seq_shard else (0, sin.shape[1])
                out.append(h + sin[:, lo:hi])
        hs = out
    return hs


def _detached(p) -> SimpleNamespace:
    return SimpleNamespace(kind=p.kind, scale=p.scale.detach(),
                           bias=None if p.bias is None else p.bias.detach())


class _DenseGrad(torch.autograd.Function):
    """The identity; its backward hands on a contiguous cotangent. A range of
    a concatenation's cotangent is a strided view, and a LayerNorm bias
    sums its cotangent's rows in an order that depends on the layout."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _group_norm(norms: list, hs: list, run: GroupRun) -> list:
    """Every rank's normed input over the whole sequence. ``seq_shard``:
    each rank norms its range, then the all-gather along the sequence.
    Otherwise each rank norms its whole copy range by range (the same
    shapes; only its own range takes the scale's gradient), then
    Megatron's f (the ranks' cotangents summed in rank order)."""
    whole = len(hs) == 1  # the norm reads h itself, as the single-device forward
    if run.seq_shard:
        own = []
        for r, h in enumerate(hs):
            with run.grp.on(r):
                # Through a view, as a range of a whole copy is below: the
                # norm's own gradient terms add up before the residual's.
                own.append(_norm(norms[r], h if whole else h.view_as(h), run.act_to))
        return sh.seq_gather(run.grp, own, run.seq)
    xs = []
    for j, h in enumerate(hs):
        with run.grp.on(j):
            if whole:
                xs.append(_norm(norms[j], h, run.act_to))
            else:
                xs.append(torch.cat([_DenseGrad.apply(_norm(
                    norms[j] if r == j else _detached(norms[j]), h[:, lo:hi].contiguous(),
                    run.act_to)) for r, (lo, hi) in enumerate(run.seq)], dim=1))
    return sh.group_copy(run.grp, xs)


def _group_add(hs: list, parts: list, run: GroupRun) -> list:
    return _add(hs, run.reduce(parts), run)


def _add(hs: list, ys: list, run: GroupRun) -> list:
    out = []
    for r, (h, y) in enumerate(zip(hs, ys)):
        with run.grp.on(r):
            out.append(h + y)
    return out


def _block_group(layers: list, hs: list, cfg: ArchConfig, kind: str, ctxs: list, run: GroupRun,
                 collect: bool = False):
    """:func:`_block_full` over the group, a block of ``kind``: returns the
    ranks' residual streams, with ``collect`` each rank's share of the
    decode cache (attention: the ``(k, v)`` of its KV heads, None for a rank
    with no head; Mamba and the RG-LRU: their state on its channels), and
    an MoE layer's routing statistics (None without)."""
    xs = _group_norm([lay.norm1 for lay in layers], hs, run)
    if kind == "ssm":
        parts, states = mamba_group([lay.ssm for lay in layers], xs, cfg, run, collect)
        return _group_add(hs, parts, run), states, None
    if kind == "rglru":
        parts, states = rglru_group([lay.rglru for lay in layers], xs, cfg, run, collect)
    else:
        parts, states = [], []
        for r, (lay, x, ctx) in enumerate(zip(layers, xs, ctxs)):
            if run.plan[r].n_heads == 0:  # a rank with no head computes no attention
                parts.append(None)
                states.append(None)
                continue
            with run.grp.on(r):
                mix, kv = attend(lay.attn, x, ctx.qpos, ctx.rot, window=ctx.window,
                                 act_to=ctx.act_to, kv_runs=run.kv_runs[r])
            parts.append(mix)
            states.append(kv)
    hs = _group_add(hs, parts, run)
    states = states if collect else None
    xs = _group_norm([lay.norm2 for lay in layers], hs, run)
    if cfg.moe is not None:
        ys, stats = moe_group([lay.moe for lay in layers], xs, cfg, run)
        return _add(hs, ys, run), states, stats
    parts = []
    for r, (lay, x) in enumerate(zip(layers, xs)):
        if run.plan[r].ff[1] == run.plan[r].ff[0]:
            parts.append(None)
            continue
        with run.grp.on(r):
            parts.append(mlp_apply(cfg.mlp, x, lay.mlp, run.act_to))
    return _group_add(hs, parts, run), states, None


def _remat_block(layers, cfg, kind, ctxs, run, *hs):
    hs, _, stats = _block_group(layers, list(hs), cfg, kind, ctxs, run)
    return tuple(hs) if stats is None else (*hs, stats)


def forward_group(views: list, batches: list, run: GroupRun, *, remat: bool = False,
                  collect: bool = False):
    """:func:`forward` over a model group: ``views`` each rank's
    :func:`params_view` of its ranges, ``batches`` each rank's copy of the
    data index's rows (positions filled). Returns every rank's final normed
    hidden states over the whole sequence (``[B, S + P, D]``, what the
    vocab-parallel head reads), the MoE layers' routing statistics (rank
    0's, per layer: :func:`aux_loss` of the data indices' mean) and, with
    ``collect``, per layer each rank's share of the decode cache
    (:func:`_block_group`). ``remat`` recomputes each block in the backward,
    keeping each rank's block input (its sequence range under
    ``seq_shard``). Every layer kind: attention blocks with a dense MLP or
    an MoE, Mamba blocks and the RG-LRU hybrid's tuple of layers."""
    cfg = views[0].cfg
    hs = _group_embed(views, batches, run)
    ctxs = []
    for r, b in enumerate(batches):
        with run.grp.on(r):
            ctxs.append(_ctx(cfg, b["positions"], run.act_to))
    states, stats = [], []
    for i in range(cfg.n_layers):
        layers = [v.layers[i] for v in views]
        kind = cfg.layer_kind(i)
        if remat:
            out = list(checkpoint(_remat_block, layers, cfg, kind, ctxs, run, *hs,
                                  use_reentrant=False, preserve_rng_state=False))
            st = out.pop() if cfg.moe is not None else None
            hs = out
        else:
            hs, layer_states, st = _block_group(layers, hs, cfg, kind, ctxs, run, collect)
            states.append(layer_states)
        if st is not None:
            stats.append(st)
    hs = _group_norm([v.final_norm for v in views], hs, run)
    return (hs, stats, states) if collect else (hs, stats)


def lm_logits_group(views: list, hs: list, run: GroupRun) -> list:
    """Each rank's logits of its vocab range (``[.., V_r]``, the activation
    dtype) from its copy of h: the columns of the LM head, or the rows of
    the tied embedding."""
    out = []
    for r, (v, h) in enumerate(zip(views, hs)):
        with run.grp.on(r):
            w = v.embed.T if v.cfg.tie_embeddings else v.lm_head
            out.append(dense(h, w, act_to=run.act_to))
    return out


# -- decode over a model group -------------------------------------------------------------


def _rank_norms(norms: list, hs: list, run: GroupRun) -> list:
    """Each rank's norm of its copy of the whole residual stream (decode:
    one token, every rank the same bits as one device)."""
    out = []
    for r, (p, h) in enumerate(zip(norms, hs)):
        with run.grp.on(r):
            out.append(_norm(p, h, run.act_to))
    return out


def _block_decode_group(layers: list, hs: list, cfg: ArchConfig, kind: str, ctxs: list,
                        run: GroupRun, cache, i: int, pos: int) -> list:
    """:func:`_block_decode` over the group, layer ``i`` of ``kind``: each
    rank takes its share of the layer's cache (``cache.share(i, r)``: its KV
    heads' ``k``/``v`` and the slots' ``pos``, or its channels of a
    recurrent state), steps on it in place, and hands it back
    (``cache.commit(i, r, share)``); attention at the rank's heads (run by
    run where they split unevenly over its KV heads; none on a rank with no
    head), the MLP over its ``d_ff``, the MoE over its experts, the
    row-parallel outputs summed over the group in rank order."""
    xs = _rank_norms([lay.norm1 for lay in layers], hs, run)
    parts = []
    if kind == "attn":
        for r, (lay, x, ctx) in enumerate(zip(layers, xs, ctxs)):
            if run.plan[r].n_heads == 0:
                parts.append(None)
                continue
            share = cache.share(i, r)
            with run.grp.on(r):
                parts.append(attend(lay.attn, x, ctx.qpos, ctx.rot, window=ctx.window,
                                    cache=share, pos=pos, act_to=ctx.act_to,
                                    kv_runs=run.kv_runs[r])[0])
            cache.commit(i, r, share)
    else:
        shares = [cache.share(i, r) for r in range(len(layers))]
        step = mamba_decode_group if kind == "ssm" else rglru_decode_group
        parts = step([getattr(lay, kind) for lay in layers], xs, shares, cfg, run)
        for r, share in enumerate(shares):
            cache.commit(i, r, share)
    hs = _group_add(hs, parts, run)
    if kind == "ssm":
        return hs
    xs = _rank_norms([lay.norm2 for lay in layers], hs, run)
    if cfg.moe is not None:
        return _add(hs, moe_group([lay.moe for lay in layers], xs, cfg, run)[0], run)
    parts = []
    for r, (lay, x) in enumerate(zip(layers, xs)):
        if run.plan[r].ff[1] == run.plan[r].ff[0]:
            parts.append(None)
            continue
        with run.grp.on(r):
            parts.append(mlp_apply(cfg.mlp, x, lay.mlp, run.act_to))
    return _group_add(hs, parts, run)


def decode_group(views: list, tokens: list, pos: int, run: GroupRun, cache) -> list:
    """:func:`decode_step` over a model group (``run.seq_shard`` False: one
    token has no sequence to shard, every rank holds the whole residual
    stream): ``views`` each rank's :func:`params_view` of its ranges,
    ``tokens`` each rank's copy of the data index's ``[B, 1]`` tokens at
    position ``pos``; ``cache`` hands each rank its share of a layer's cache
    and takes back what the rank wrote (:func:`_block_decode_group`). The
    vocab-parallel embedding's parts summed (exact; f32, as the single
    device's decode leaves it), the blocks in turn, the final norm, and each
    rank's logits of its vocab range (``[B, V_r]``, the activation dtype)."""
    cfg = views[0].cfg
    b = tokens[0].shape[0]
    shape = (b, 1, 3) if cfg.mrope_sections is not None else (b, 1)
    parts = []
    for r, (v, t) in enumerate(zip(views, tokens)):
        with run.grp.on(r):
            parts.append(_vocab_lookup(v, t, run.plan[r].vocab).to(f32))
    hs = sh.group_sum(run.grp, parts)
    ctxs = []
    for r, t in enumerate(tokens):
        with run.grp.on(r):
            positions = torch.full(shape, pos, dtype=torch.int32, device=t.device)
            if cfg.rotary_pct == 0.0 and cfg.mrope_sections is None:
                hs[r] = hs[r] + _sinusoidal(positions, cfg.d_model)
            ctxs.append(_ctx(cfg, positions, run.act_to))
    for i in range(cfg.n_layers):
        hs = _block_decode_group([v.layers[i] for v in views], hs, cfg, cfg.layer_kind(i), ctxs,
                                 run, cache, i, pos)
    hs = _rank_norms([v.final_norm for v in views], hs, run)
    return lm_logits_group(views, [h[:, 0] for h in hs], run)
