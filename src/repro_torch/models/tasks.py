"""Task builders: train, prefill and decode steps per (arch x shape)
(``repro/models/tasks.py``).

``make_*_step`` return plain functions of the model (or the train state)
and its inputs; :func:`build_task` assembles a cell's :class:`Task` (the
step, its inputs as ``meta`` tensors, nothing allocated, and the
shardings of its arguments and outputs on a mesh).

A train state is the reference's tree: ``params`` (the storage dtype),
``master`` (the f32 masters, or None where the policy keeps none), ``opt``
(:class:`repro_torch.optim.adamw.OptState`) and ``scale``
(:class:`ScaleState`), each parameter tree in the reference's layout
(:func:`repro_torch.models.transformer.params_tree`: ``layers`` leaves
stacked ``[L, ...]``, or the hybrid's tuple of per-layer trees), so
``checkpoint/ckpt.save`` writes the reference's leaf names, shapes and
dtypes. Under the vision frontend a batch carries ``patch_embeds`` and
M-RoPE ``positions`` beside its text ``tokens``, and the loss runs over
the text positions only.

**On a mesh** (``mesh=``, a device list: ``launch/mesh.make_host_mesh``),
the reference jits its step with in/out shardings and leaves the
collectives to GSPMD; one PyTorch process has none, so the port lowers
the step itself over :mod:`repro_torch.launch.mesh`'s sharded tensors:

- *State.* Every leaf of ``params``, ``master``, ``opt.m`` and ``opt.v``
  is held as blocks per :func:`_state_pspecs` (the parameter rules,
  fitted); scalars are replicated, a copy per entry.
- *Compute* runs over the data axes and ``model`` (``launch/mesh.model_compute``:
  ``"megatron"`` for every arch and step). Each data index takes its rows of the
  batch (``batch_pspecs``; a batch the data axes do not divide is one data
  index's). The masters are cast to the storage dtype on their owners (the
  reference's pinned cast), so every gather moves storage bytes. Each of
  its m model ranks gathers only its ranges (``launch/mesh.compute_plan``,
  :func:`_rank_regions`): whole heads of ``wq``/``wk``/``wv``/``wo`` and
  the biases, a range of ``d_ff`` of ``w_gate``/``w_up``/``w_down`` (of
  ``d_shared`` for qwen2-moe's shared expert), a vocab range of ``embed``
  and ``lm_head``, its experts (EP, where the expert count divides m) or a
  range of ``d_expert`` in every expert (TP), its channels of Mamba's
  ``d_inner`` (both halves of ``in_proj``: two regions) and of the
  RG-LRU's width; norms and the router whole. A region of the
  column-sharded storage need not align with its blocks. The group runs
  :func:`repro_torch.models.transformer.forward_group`: column-parallel
  projections, row-parallel ones summed over the group in rank order (no
  float atomics), the vocab-parallel embedding and loss (per chunk the
  max, the sum of exponentials and the target logit each all-reduced in
  rank order), the MoE routed on every rank and combined in the
  reference's order, Mamba's ``x_proj`` all-reduced before its split, the
  RG-LRU's conv output all-gathered before its gates. B7 and
  ``flash_attn_bwd`` run at each rank's heads on the card; a rank with no
  head computes no attention.
- *Loss.* Each data index's masked NLL sum, added in data-index order
  (an all-reduce) and divided by the global mask count: ``chunked_ce``
  over the whole batch. The MoE load-balance loss is not additive over
  rows, so its routing statistics are averaged over the data indices
  first (:func:`repro_torch.models.transformer.aux_loss`). Each data
  index's backward starts from the cotangents of that global loss.
- *Gradients* are cast to f32 and reduce-scattered straight into the
  master layout in data-index order (then model-rank order, each rank's
  over its ranges); then the finite check over all
  blocks (one replicated flag), the global norm summed leaf by leaf in the
  single-device step's leaf order, AdamW on each block on its owner, the
  scale update, and the new params cast to storage on the owners.
  ``microbatch`` slices the global batch as on one device (each data
  index all-gathers the batch and takes its rows of each slice).
- *Serving* (``make_prefill_step(mesh=)``, the decode task): params held
  per ``param_pspec``, the KV/SSM cache per ``cache_pspec``; each data
  index's model ranks gather their ranges and its rows of the inputs.
  Prefill runs the split forward (the ranks' logits gathered along the
  vocab, their KV heads and recurrent states' channels into the cache,
  which goes back to its group). Decode runs the one-token forms of the
  split layers (``transformer.decode_group``): per attention layer each
  rank with heads assembles its KV heads' rows of the cache from the
  blocks (along ``Dh`` under the ``"headdim"`` layout, along the slots
  under ``"seq"``), writes the new token into slot ``pos mod C`` and
  attends at its query heads (B7's decode path), and the new slot goes
  back into every block that holds part of it; a recurrent layer's state
  is gathered and written back on the rank's channels. The cache is
  updated in place (the reference donates it) and no step holds a data
  index's whole cache; each rank's vocab range of the logits goes to its
  blocks.
- ``seq_shard`` (the reference's default) shards the residual stream's
  sequence over ``model`` between blocks under model-axis compute
  (Megatron's sequence parallelism: norms on a rank's range, an all-gather
  before and a reduce-scatter after each split projection, remat keeping
  the range). Every sum runs in the same rank order without it, so
  ``seq_shard`` True and False give the same bits, as the reference's
  layout constraint does.

On a mesh of ``meta`` devices (the dry-run) one data index computes and
the others contribute its tensors: every collective still runs, and is
counted, for each.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.distributed import (
    note_collective, note_gathered, on_entry, recording_collectives, replay_collectives,
)
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharded as sh
from repro_torch.launch.mesh import NamedSharding, P
from repro_torch.launch.sharded import Sharded
from repro_torch.models import transformer as tf
from repro_torch.models.layers import act_dtype, dense
from repro_torch.optim.adamw import (
    AdamWConfig, OptState, ScaleState, adamw_init, adamw_update, scale_init, scale_update,
    step_scalars, update_leaf,
)
from repro_torch.precision import PrecisionPolicy, get_policy
from repro_torch.precision.policy import _flatten, tree_leaves, tree_map

__all__ = ["Task", "build_task", "input_specs", "train_state_specs", "make_prefill_step",
           "make_decode_step", "make_train_step", "init_train_state", "chunked_ce"]

f32 = torch.float32


def _targets(cfg: ArchConfig, full: dict, h: torch.Tensor):
    """``(h, targets, mask)`` of the loss: next-token targets with the last
    position masked, over the text positions only under the vision
    frontend."""
    tokens = full["tokens"]
    if cfg.frontend == "vision":
        h = h[:, cfg.n_patches:]  # the loss runs over the text positions only
    targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = torch.cat([torch.ones(tokens[:, 1:].shape, dtype=f32, device=tokens.device),
                      torch.zeros(tokens[:, :1].shape, dtype=f32, device=tokens.device)], dim=1)
    return h, targets, mask


def _fill_positions(cfg: ArchConfig, batch: dict) -> dict:
    """Materialise default positions ``arange(S)`` per row when the batch
    does not carry them."""
    if "positions" in batch:
        return batch
    b, s = batch["tokens"].shape
    pos = torch.arange(s, dtype=torch.int32, device=batch["tokens"].device)
    return dict(batch, positions=pos.expand(b, s).contiguous())


# -- loss ----------------------------------------------------------------------------


def _ce_chunk(hc, w, tc, mc, act_to):
    # logits may be bf16 under the optimized policy; the CE reduction itself
    # always runs in f32.
    logits = dense(hc, w, act_to=act_to).to(f32)  # [B, c, V]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, tc[..., None])[..., 0]
    return torch.sum((lse - tgt) * mc)


def chunked_ce(model, cfg: ArchConfig, h: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor, *, chunk: int = 512,
               act_to: torch.dtype | None = None) -> torch.Tensor:
    """Cross-entropy over the vocab without materializing ``[B, S, V]``:
    chunks of ``chunk`` positions, each recomputed in the backward, logits
    through the tied embedding or the LM head of ``model`` (a
    :class:`~repro_torch.models.transformer.Transformer` or a
    :func:`~repro_torch.models.transformer.params_view`) in the activation
    dtype ``act_to``, then f32; the masked sum over the chunks in order,
    divided by ``max(sum(mask), 1)``."""
    nll, count = _ce_parts(model, cfg, h, targets, mask, chunk=chunk, act_to=act_to)
    return nll / torch.clamp(count, min=1.0)


def _ce_sum(model, cfg: ArchConfig, h, targets, mask, c: int, act_to) -> torch.Tensor:
    """The masked NLL summed over chunks of ``c`` positions in order, f32
    (the inputs padded to a multiple of ``c``)."""
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    total = torch.zeros((), dtype=f32, device=h.device)
    for i in range(0, h.shape[1], c):
        total = total + checkpoint(_ce_chunk, h[:, i:i + c], w, targets[:, i:i + c],
                                   mask[:, i:i + c], act_to, use_reentrant=False,
                                   preserve_rng_state=False)
    return total


def _ce_parts(model, cfg: ArchConfig, h, targets, mask, *, chunk: int, act_to):
    """``(nll sum, mask count)`` of :func:`chunked_ce`: a data index's
    share of the global loss."""
    s = h.shape[1]
    c = min(chunk, s)
    pad = -s % c
    count = torch.sum(mask)
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    return _ce_sum(model, cfg, h, targets, mask, c, act_to), count


# -- train state -----------------------------------------------------------------------


def init_train_state(cfg: ArchConfig, policy: PrecisionPolicy, seed: int = 0,
                     opt_cfg: AdamWConfig = AdamWConfig(), *, device=None) -> dict:
    """The reference's train state of a model drawn from ``seed``
    (:func:`repro_torch.models.transformer.init_params` in f32) on
    ``device`` (None: the card, raising without one): ``params`` in the
    policy's storage dtype, ``master`` (f32, None unless the policy keeps
    masters), ``opt`` and ``scale``. ``opt_cfg`` is unused, as in the
    reference."""
    if isinstance(policy, str):
        policy = get_policy(policy)
    model = tf.init_params(cfg, get_policy("fp32"), seed=seed, device=device)
    master = tf.params_tree(model)
    dev = master["embed"].device
    return {
        "params": tree_map(lambda x: x.to(policy.param_storage), master),
        "master": master if policy.master_fp32 else None,
        "opt": adamw_init(master),
        "scale": scale_init(policy.loss_scale, device=dev),
    }


def train_state_specs(cfg: ArchConfig, policy: PrecisionPolicy) -> dict:
    """The train state's tree on the ``meta`` device (leaf names, shapes
    and dtypes; nothing drawn or allocated), from :func:`init_train_state`
    itself: the counterpart of the reference's ``jax.eval_shape``."""
    return init_train_state(cfg, policy, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The model inputs of a cell as ``meta`` tensors, the reference's
    dtypes: int32 tokens (``[B, 1]`` and a scalar ``pos`` for decode), bf16
    ``patch_embeds`` and int32 M-RoPE ``positions`` under the vision
    frontend."""
    b, s = shape.global_batch, shape.seq_len

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"token": spec((b, 1), torch.int32), "pos": spec((), torch.int32)}
    if cfg.frontend == "vision":
        p = cfg.n_patches
        return {"tokens": spec((b, s - p), torch.int32),
                "patch_embeds": spec((b, p, cfg.d_model), torch.bfloat16),
                "positions": spec((b, s, 3), torch.int32)}
    return {"tokens": spec((b, s), torch.int32)}


def _state_pspecs(state_specs, mesh):
    """The specs of a train state's leaves: ``params`` and ``master`` by the
    parameter rules, ``opt.m`` and ``opt.v`` likewise (their leading keys
    dropped), everything else replicated; each fitted to the mesh."""
    def rule(keys, leaf, m):
        if keys and keys[0] in ("params", "master"):
            return meshlib.param_pspec(keys[1:], leaf, m)
        if len(keys) > 1 and keys[0] == "opt" and keys[1] in ("m", "v"):
            return meshlib.param_pspec(keys[2:], leaf, m)
        return P()

    return meshlib.tree_pspecs(state_specs, mesh, rule=rule)


# -- step functions ----------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, policy: PrecisionPolicy, *, mesh=None,
                    seq_shard: bool = True, remat: bool = True, microbatch: int = 1,
                    opt_cfg: AdamWConfig = AdamWConfig(), aux_weight: float = 0.01,
                    ce_chunk: int = 512):
    """``train_step(state, batch)`` -> ``(state, metrics)``, as the
    reference's: the loss of the masters cast to the storage dtype (whose
    backward rounds each gradient to that dtype: loss scaling guards it),
    next-token targets with the last position masked, times the loss
    scale; ``microbatch`` slices of the batch with their gradients summed
    in f32, then divided; gradients to f32 over the scale, a finite check,
    AdamW skipping a non-finite step (``torch.where``, no host sync), the
    dynamic scale's update and the new params in the storage dtype.
    Metrics: ``loss``, ``grad_norm``, ``loss_scale`` and ``skipped`` (0-d
    f32 tensors on the state's device). Attention runs B7 and the
    ``flash_attn_bwd`` kernel on the card (``ops.AttentionFn``), their
    plain versions on the CPU. With ``mesh`` the step runs over the mesh's
    lowering (the module's docstring): ``state`` and ``batch`` may be
    tensors or :class:`~repro_torch.launch.sharded.Sharded` trees, the state
    comes back laid out per :func:`_state_pspecs`, the metrics on the
    mesh's first device. Every arch computes over the ``model`` axis too
    (:func:`repro_torch.launch.mesh.compute_plan`), with the residual stream
    sequence-sharded under ``seq_shard``, which changes no bit."""
    if isinstance(policy, str):
        policy = get_policy(policy)
    act_to = act_dtype(policy.compute)
    if mesh is not None:
        return _sharded_train_step(cfg, policy, mesh, seq_shard=seq_shard, remat=remat,
                                   microbatch=microbatch, opt_cfg=opt_cfg,
                                   aux_weight=aux_weight, ce_chunk=ce_chunk)

    def loss_fn(master, batch, scale):
        params = tree_map(lambda x: x.to(policy.param_storage), master)
        model = tf.params_view(cfg, params)
        full = _fill_positions(cfg, batch)
        h, aux = tf.forward(model, full, act_to=act_to, remat=remat)
        h, targets, mask = _targets(cfg, full, h)
        loss = chunked_ce(model, cfg, h, targets, mask, chunk=ce_chunk, act_to=act_to)
        loss = loss + aux_weight * aux
        return loss * scale, loss

    def value_and_grad(master, batch, scale):
        leaves, rebuild = _flatten(master)
        leaves = [x.detach().requires_grad_() for x in leaves]
        with torch.enable_grad():
            scaled, loss = loss_fn(rebuild(leaves), batch, scale)
            grads = torch.autograd.grad(scaled, leaves)
        return loss.detach(), rebuild(list(grads))

    def train_step(state: dict, batch: dict):
        master = state["master"] if state["master"] is not None else state["params"]
        scale = state["scale"].scale
        if microbatch > 1:
            grads = tree_map(lambda x: torch.zeros(x.shape, dtype=f32, device=x.device), master)
            loss = torch.zeros((), dtype=f32, device=scale.device)
            mbs = {k: v.reshape((microbatch, v.shape[0] // microbatch) + v.shape[1:])
                   for k, v in batch.items()}
            for i in range(microbatch):
                l_i, g_i = value_and_grad(master, {k: v[i] for k, v in mbs.items()}, scale)
                grads = tree_map(torch.add, grads, g_i)
                loss = loss + l_i
            grads = tree_map(lambda g: g / microbatch, grads)
            loss = loss / microbatch
        else:
            loss, grads = value_and_grad(master, batch, scale)
        grads = tree_map(lambda g: g.to(f32) / scale, grads)
        finite = torch.stack([torch.isfinite(g).all() for g in tree_leaves(grads)]).all()
        new_master, new_opt, gnorm = adamw_update(opt_cfg, grads, state["opt"], master,
                                                  skip=~finite)
        new_scale = scale_update(state["scale"], finite)
        new_state = {
            "params": tree_map(lambda x: x.to(policy.param_storage), new_master),
            "master": new_master if state["master"] is not None else None,
            "opt": new_opt,
            "scale": new_scale,
        }
        metrics = {"loss": loss, "grad_norm": gnorm, "loss_scale": new_scale.scale,
                   "skipped": (~finite).to(f32)}
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, policy: PrecisionPolicy, *, mesh=None,
                      seq_shard: bool = True, collect_cache: bool = False,
                      cache_len: int = 0):
    """``prefill_step(model, batch)`` -> last-position logits ``[B, V]``
    (and, with ``collect_cache``, the decode cache of ``cache_len`` slots
    in the policy's state storage dtype). Activations run in the policy's
    compute dtype, as the reference's step sets them. With ``mesh``,
    ``model`` is a parameter tree (``params_tree``'s layout; tensors or
    :class:`~repro_torch.launch.sharded.Sharded`, laid out per
    ``param_pspec``) and the step runs over the mesh's lowering: logits
    laid out per ``P(data, "model")`` and the cache per ``cache_pspec``,
    both fitted; the forward computes over the ``model`` axis
    (``seq_shard`` changes no bit)."""
    act_to = act_dtype(policy.compute)
    if mesh is not None:
        return _sharded_prefill_step(cfg, policy, mesh, seq_shard, collect_cache, cache_len)

    def prefill_step(model: tf.Transformer, batch: dict):
        full = _fill_positions(cfg, batch)
        out = tf.forward(model, full, collect_cache=collect_cache, cache_len=cache_len,
                         cache_dtype=policy.state_storage, act_to=act_to)
        if collect_cache:
            h, _, cache = out
            return tf.lm_logits(model, h[:, -1], act_to), cache
        return tf.lm_logits(model, out[0][:, -1], act_to)

    return prefill_step


def make_decode_step(cfg: ArchConfig, policy: PrecisionPolicy, *, mesh=None):
    """``decode_fn(model, cache, token, pos)`` -> ``(logits, cache)``,
    activations in the policy's compute dtype. With ``mesh`` (the port's:
    the reference's decode takes its layout from ``jit``), ``model`` is a
    parameter tree and the step runs over the mesh's lowering, the cache
    laid out per ``cache_pspec``."""
    act_to = act_dtype(policy.compute)
    if mesh is not None:
        return _sharded_decode_step(cfg, policy, mesh)

    def decode_fn(model: tf.Transformer, cache: dict, token: torch.Tensor, pos: int):
        return tf.decode_step(model, cache, token, pos, act_to)

    return decode_fn


# -- the mesh lowering ------------------------------------------------------------------


def _groups(mesh) -> list[tuple]:
    """Each data index's compute entry (model rank 0), in data-index order
    (row-major over the data axes, as the batch dim's blocks)."""
    d = meshlib.data_axes(mesh)
    sizes = mesh.shape
    out = []
    for coords in itertools.product(*(range(sizes[a]) for a in d)):
        at = dict(zip(d, coords))
        out.append(tuple(at.get(a, 0) for a in mesh.axis_names))
    return out


def _dry(mesh) -> bool:
    """A mesh of ``meta`` devices: one data index computes for all."""
    return all(dev.type == "meta" for dev in mesh.devices.flat)


def _place(tree, specs, mesh):
    """``tree`` laid out per ``specs`` (tensors sharded, Sharded leaves kept
    or re-laid out)."""
    return sh.shard_tree(tree, meshlib.named(specs, mesh))


def _blockwise(x: Sharded, fn) -> Sharded:
    """``fn`` of every block on its owner, as a Sharded of x's layout."""
    mesh = x.mesh
    blocks = x.blocks.copy()
    for e in sh.entries(mesh):
        with on_entry(mesh, e):
            blocks[e] = fn(x.blocks[e])
    return Sharded(x.sharding, x.shape, blocks.flat[0].dtype, blocks)


def _replicated(value: torch.Tensor, mesh) -> Sharded:
    """A scalar computed once (from replicated inputs) held by every entry."""
    sharding = NamedSharding(mesh, P())
    blocks = sh.blocks_of(mesh, lambda e: value.to(mesh.devices[e], copy=True))
    return Sharded(sharding, tuple(value.shape), value.dtype, blocks)


def _first(x: Sharded) -> torch.Tensor:
    return x.blocks.flat[0]


def _split(b: int, mesh) -> int:
    """How many data indices share ``b`` rows: all of them where they
    divide it, else one (as ``fit_spec`` leaves such a batch whole)."""
    n = len(_groups(mesh))
    return n if b % n == 0 else 1


# -- model-axis compute (Megatron splits over `model`) ------------------------------------


def _rank_ents(mesh, e0: tuple) -> tuple:
    """The entries of ``e0``'s model group in rank order (``e0`` alone
    without a ``model`` axis)."""
    if "model" not in mesh.axis_names:
        return (e0,)
    i = mesh.axis_names.index("model")
    return tuple(e0[:i] + (r,) + e0[i + 1:] for r in range(mesh.shape["model"]))


def _moved_to(mesh, e0: tuple):
    """An entry of another data index's group moved into ``e0``'s (its data
    coordinates replaced by ``e0``'s)."""
    d = [i for i, a in enumerate(mesh.axis_names) if a in meshlib.data_axes(mesh)]
    return lambda e: tuple(e0[i] if i in d else x for i, x in enumerate(e))


def _rank_regions(keys, shape: tuple, pl: meshlib.RankPlan, cfg: ArchConfig) -> list:
    """The regions (tuples of slices) of a parameter leaf (path ``keys``,
    stacked ``[L, ...]`` or not) that rank ``pl`` computes with: its query
    heads' columns of ``wq``/``bq`` and rows of ``wo``, its KV heads'
    columns of ``wk``, ``wv``, ``bk``, ``bv``, its ``d_ff`` (a shared
    expert's ``d_shared``) columns of ``w_gate``/``w_up`` and rows of
    ``w_down``, its vocab rows of ``embed`` and columns of ``lm_head``; of
    the routed experts its experts (EP) or its ``d_expert`` columns and rows
    (TP); of Mamba its ``d_inner`` channels (both halves of ``in_proj``:
    two regions, in that order; the columns of the conv, ``dt_proj``,
    ``dt_bias`` and ``D``; the rows of ``x_proj``, ``A_log`` and
    ``out_proj``); of the RG-LRU its width channels (the columns of
    ``in_proj``, ``gate_proj``, ``w_a``, ``w_x``, the conv, ``b_a``, ``b_x``
    and ``lam``; the rows of ``out_proj``); norms and the router whole."""
    out = [slice(0, n) for n in shape]
    name = keys[-1]
    if "ssm" in keys:
        ch = slice(*pl.inner)
        if name == "in_proj":  # [D, 2 Di]: its channels of the x half and of the z half
            di = shape[-1] // 2
            return [tuple(out[:-1] + [ch]), tuple(out[:-1] + [slice(di + ch.start, di + ch.stop)])]
        cols = dict.fromkeys(("conv_w", "conv_b", "dt_proj", "dt_bias", "D"), ch)
        rows = dict.fromkeys(("x_proj", "A_log", "out_proj"), ch)
    elif "rglru" in keys:
        ch = slice(*pl.lru)
        cols = dict.fromkeys(("in_proj", "gate_proj", "w_a", "w_x", "conv_w", "conv_b", "b_a",
                              "b_x", "lam"), ch)
        rows = {"out_proj": ch}
    elif "moe" in keys and "shared" not in keys:
        ef = slice(*pl.expert_ff)
        cols, rows = {"w_gate": ef, "w_up": ef}, {"w_down": ef}
        if name in ("w_gate", "w_up", "w_down"):
            out[-3] = slice(*pl.experts)
    else:
        hd = cfg.head_dim
        q = slice(pl.q_heads[0] * hd, pl.q_heads[1] * hd)
        kv = slice(pl.kv_heads[0] * hd, pl.kv_heads[1] * hd)
        ff, vocab = slice(*(pl.shared if "shared" in keys else pl.ff)), slice(*pl.vocab)
        cols = {"wq": q, "bq": q, "wk": kv, "wv": kv, "bk": kv, "bv": kv, "w_gate": ff,
                "w_up": ff, "lm_head": vocab}
        rows = {"wo": q, "w_down": ff, "embed": vocab}
    if name in cols:
        out[-1] = cols[name]
    elif name in rows:
        out[-2] = rows[name]
    return [tuple(out)]


def _pieces(regions: list, t: torch.Tensor):
    """``(region, piece)`` of a rank's tensor over its ``regions`` of a leaf
    (laid side by side along the last dim), the empty ones left out."""
    widths = [reg[-1].stop - reg[-1].start for reg in regions]
    for reg, piece in zip(regions, torch.split(t, widths, dim=-1) if len(regions) > 1 else [t]):
        if all(sl.stop > sl.start for sl in reg):
            yield reg, piece


def _seq_len(cfg, rows: dict) -> int:
    """The whole sequence of a batch like ``rows``, prefix included."""
    return rows["tokens"].shape[1] + (cfg.n_patches if cfg.frontend == "vision" else 0)


def _group_run(cfg, mesh, e0: tuple, plan: list, s: int, seq_shard: bool, act_to
               ) -> tf.GroupRun:
    """The :class:`~repro_torch.models.transformer.GroupRun` of ``e0``'s
    model group over a sequence of ``s`` positions: each rank's sequence
    range and its attention runs."""
    g = cfg.n_heads // cfg.n_kv_heads
    runs = []
    for pl in plan:
        r = pl.kv_runs(g)
        even = len(r) == pl.n_kv and len({hi - lo for lo, hi, _ in r}) <= 1
        runs.append(None if even else r)
    grp = sh.Group(mesh, _rank_ents(mesh, e0))
    return tf.GroupRun(grp=grp, plan=plan, seq=meshlib.balanced(s, len(plan)),
                       seq_shard=seq_shard, act_to=act_to, kv_runs=runs)


class _VocabLSE(torch.autograd.Function):
    """The rows' log-sum-exp over a model group's vocab ranges (``logits[r]``
    rank ``r``'s ``[.., V_r]`` f32): the ranks' maxima and then their sums
    of exponentials all-reduced in rank order, ``log(sum) + max`` on the
    first rank (``torch.logsumexp``'s formula, so one rank gives its bits);
    the backward gives each rank ``g exp(l - lse)`` (its formula too)."""

    @staticmethod
    def forward(ctx, grp, *logits):
        maxes = []
        for r, lg in enumerate(logits):
            with grp.on(r):
                maxes.append(torch.amax(lg, dim=-1))
        top = maxes[0]
        for mx in maxes[1:]:
            top = torch.maximum(top, mx.to(top.device))
        sums = []
        for r, lg in enumerate(logits):
            with grp.on(r):
                sums.append(torch.sum(torch.exp(lg - top.to(lg.device)[..., None]), dim=-1))
        total = sums[0]
        for t in sums[1:]:
            total = total + t.to(total.device)
        lse = torch.log(total) + top
        each = (len(logits) - 1) * 2 * top.numel() * top.element_size()
        note_collective("all-reduce", {e: each for e in grp.ents})
        ctx.grp = grp
        ctx.save_for_backward(lse, *logits)
        return lse

    @staticmethod
    def backward(ctx, g):
        lse, *logits = ctx.saved_tensors
        out = []
        for r, lg in enumerate(logits):
            with ctx.grp.on(r):
                dev = lg.device
                out.append(g.to(dev)[..., None] * torch.exp(lg - lse.to(dev)[..., None]))
        return (None, *out)


def _ce_group_chunk(views, run, tcs, mc, *hcs):
    """One chunk's masked NLL sum over the group (:func:`_ce_chunk`'s): each
    rank's logits of its vocab range, the log-sum-exp over the ranges, the
    target logit from the rank whose range holds it (the others add 0)."""
    logits = [lg.to(f32) for lg in tf.lm_logits_group(views, list(hcs), run)]
    lse = _VocabLSE.apply(run.grp, *logits)
    tgt = None
    for r, (lg, tc) in enumerate(zip(logits, tcs)):
        with run.grp.on(r):
            lo, hi = run.plan[r].vocab
            if (lo, hi) == (0, views[r].cfg.vocab_size):
                t = torch.gather(lg, -1, tc[..., None])[..., 0]
            else:
                inside = (tc >= lo) & (tc < hi)
                t = torch.gather(lg, -1, torch.where(inside, tc - lo, 0)[..., None])[..., 0]
                t = torch.where(inside, t, torch.zeros((), dtype=t.dtype, device=t.device))
        tgt = t if tgt is None else tgt + t.to(tgt.device)
    if len(logits) > 1:
        note_collective("all-reduce", {e: (len(logits) - 1) * tgt.numel() * tgt.element_size()
                                       for e in run.grp.ents})
    return torch.sum((lse - tgt) * mc)


def _ce_group_parts(views, run, trip: list, *, chunk: int):
    """``(nll sum, mask count)`` of a data index's rows over its model group
    (:func:`_ce_parts`, vocab-parallel): ``trip`` each rank's ``(h,
    targets, mask)``, h over the whole sequence; chunks of ``chunk``
    positions, each recomputed in the backward; on the first rank."""
    hs = [t[0] for t in trip]
    s = hs[0].shape[1]
    c = min(chunk, s)
    pad = -s % c
    mask = trip[0][2]
    count = torch.sum(mask)
    tcs = [t[1] for t in trip]
    if pad:
        for r, h in enumerate(hs):
            with run.grp.on(r):
                hs[r] = torch.nn.functional.pad(h, (0, 0, 0, pad))
        tcs = [torch.nn.functional.pad(t, (0, pad)) for t in tcs]
        mask = torch.nn.functional.pad(mask, (0, pad))
    total = torch.zeros((), dtype=f32, device=hs[0].device)
    for i in range(0, hs[0].shape[1], c):
        total = total + checkpoint(_ce_group_chunk, views, run, [t[:, i:i + c] for t in tcs],
                                   mask[:, i:i + c], *[h[:, i:i + c] for h in hs],
                                   use_reentrant=False, preserve_rng_state=False)
    return total, count


def _sharded_train_step(cfg, policy, mesh, *, seq_shard, remat, microbatch, opt_cfg,
                        aux_weight, ce_chunk):
    act_to = act_dtype(policy.compute)
    d_axes = meshlib.data_axes(mesh)
    groups = _groups(mesh)
    dry = _dry(mesh)
    plan = meshlib.compute_plan(cfg, meshlib.model_size(mesh))

    def global_loss(src_entries, outs, scale):
        """The loss from every data index's (nll, count, stats), detached
        copies taking the gradient; returns (loss, scaled, their inputs)."""
        with torch.enable_grad():
            ins = [[t.detach().requires_grad_() for t in (nll, *stats)] for nll, _, stats in outs]
            nll = sh.all_reduce([(e, x[0]) for e, x in zip(src_entries, ins)])
            count = sh.all_reduce([(e, o[1]) for e, o in zip(src_entries, outs)])
            loss = nll / torch.clamp(count, min=1.0)
            dev = loss.device
            if cfg.moe is not None:
                n = len(outs)
                means = [sh.all_reduce([(e, x[1 + i]) for e, x in zip(src_entries, ins)])
                         / n for i in range(len(outs[0][2]))]
                aux = tf.aux_loss(cfg, means, dev)
            else:
                aux = torch.zeros((), dtype=f32, device=dev)
            loss = loss + aux_weight * aux
            scaled = loss * scale.to(dev)
        return loss, scaled, ins

    def rows_of(batch, src):
        """Per microbatch, every data index's rows taken on ``entry`` (a
        function of the data index's position and the entry)."""
        leaves, rebuild_batch = _flatten(batch)
        b = leaves[0].shape[0]
        every = tuple(mesh.axis_names)
        row_axes = meshlib.model_axes(mesh)
        whole = {}

        def rows(i, gi, entry):
            if microbatch > 1:  # each data index takes its rows of every slice
                if entry not in whole:
                    whole[entry] = [sh.all_gather(x, entry, every)[0] for x in leaves]
                per = b // microbatch // len(src)
                lo = i * (b // microbatch) + gi * per
                return rebuild_batch([t[lo:lo + per] for t in whole[entry]])
            # its group's blocks over `model` (the whole batch if unsplit)
            return rebuild_batch([sh.all_gather(x, entry, row_axes)[0] for x in leaves])

        return rows

    def megatron_grads(storage, rebuild, batch, scale, src, run):
        """Every data index's model group computes: each rank gathers its
        ranges of the storage-dtype leaves and runs its share of the
        forward (:func:`repro_torch.models.transformer.forward_group`) and
        of the vocab-parallel loss; returns per data index each rank's f32
        gradients over its ranges (summed over the microbatches), the loss,
        and the ranks' regions."""
        regions, gathered = _gather_ranges(rebuild(storage), mesh, src, run, cfg, plan)
        for ranks in gathered.values():
            for leaves in ranks:
                for t in leaves:
                    t.requires_grad_()
        rows_at = rows_of(batch, src)
        acc, loss_sum = {}, None
        group_log: list = []  # the computing group's collectives (dry: counted for each)
        for i in range(microbatch):
            outs = []
            for gi, e in enumerate(src):
                rows = [rows_at(i, gi, er) for er in _rank_ents(mesh, e)]
                if e not in run:
                    outs.append(outs[0])
                    continue
                with torch.enable_grad(), recording_collectives(group_log):
                    outs.append(megatron_loss(e, gathered[e], rebuild, rows))
            with on_entry(mesh, run[0]):
                loss, scaled, ins = global_loss(src, outs, scale)
                cot = torch.autograd.grad(scaled, [t for x in ins for t in x])
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
            k = 0
            for e, (nll, _, stats), x in zip(src, outs, ins):
                d_out, k = cot[k:k + len(x)], k + len(x)
                if e not in run:
                    continue
                flat = [t for leaves in gathered[e] for t in leaves]
                with on_entry(mesh, e), recording_collectives(group_log):
                    grads = torch.autograd.grad([nll, *stats], flat, grad_outputs=d_out,
                                                allow_unused=True)
                grads = [torch.zeros(t.shape, dtype=f32, device=t.device) if g is None
                         else g.to(f32) for g, t in zip(grads, flat)]
                n = len(storage)
                per_rank = [grads[r * n:(r + 1) * n] for r in range(len(plan))]
                acc[e] = per_rank if e not in acc else [[a + g for a, g in zip(ra, rg)]
                                                        for ra, rg in zip(acc[e], per_rank)]
        for e in src:
            if e not in run:
                replay_collectives(group_log, _moved_to(mesh, e))
        return acc, (loss_sum / microbatch if microbatch > 1 else loss_sum), regions

    def megatron_loss(e, leaves, rebuild, rows):
        """A data index's (nll, count, MoE routing statistics) over its model
        group."""
        run = _group_run(cfg, mesh, e, plan, _seq_len(cfg, rows[0]), seq_shard, act_to)
        views = [tf.params_view(cfg, rebuild(lv), heads=(pl.n_heads, pl.n_kv))
                 for lv, pl in zip(leaves, plan)]
        full = [_fill_positions(cfg, r) for r in rows]
        hs, stats = tf.forward_group(views, full, run, remat=remat)
        trip = []
        for r, (h, f) in enumerate(zip(hs, full)):
            with run.grp.on(r):
                trip.append(_targets(cfg, f, h))
        nll, count = _ce_group_parts(views, run, trip, chunk=ce_chunk)
        return nll, count, stats

    def update(state, master_leaves, grads, finite):
        """AdamW on every block on its owner, the global norm summed leaf by
        leaf, the scale update and the new params cast on the owners."""
        entries = sh.entries(mesh)
        sq = None
        for g in grads:  # the single-device step's leaf order
            parts = []
            for e in g.distinct():
                with on_entry(mesh, e):
                    parts.append((e, torch.sum(torch.square(g.blocks[e].to(f32)))))
            leaf = sh.all_reduce(parts)
            sq = leaf if sq is None else sq + leaf.to(sq.device)
        gnorm = torch.sqrt(sq)
        skip = ~finite
        opt = state["opt"]
        sc = step_scalars(opt_cfg, _first(opt.step), gnorm)
        new = ([], [], [])  # m, v, masters
        for g, m, v, p in zip(grads, tree_leaves(opt.m), tree_leaves(opt.v), master_leaves):
            blocks = [p.blocks.copy() for _ in range(3)]
            for e in entries:
                with on_entry(mesh, e):
                    dev = mesh.devices[e]
                    out = update_leaf(opt_cfg, type(sc)(*(t.to(dev) for t in sc)), g.blocks[e],
                                      m.blocks[e], v.blocks[e], p.blocks[e], skip.to(dev))
                for k in range(3):
                    blocks[k][e] = out[k]
            for k in range(3):
                new[k].append(Sharded(p.sharding, p.shape, f32, blocks[k]))
        new_scale = scale_update(ScaleState(*(_first(t) for t in state["scale"])), finite)
        step = torch.where(skip, _first(opt.step), sc.step)
        _, rebuild = _flatten(state["params"])
        return {
            "params": rebuild([_blockwise(x, lambda t: t.to(policy.param_storage))
                               for x in new[2]]),
            "master": rebuild(new[2]) if state["master"] is not None else None,
            "opt": OptState(m=rebuild(new[0]), v=rebuild(new[1]), step=_replicated(step, mesh)),
            "scale": ScaleState(*(_replicated(t, mesh) for t in new_scale)),
        }, gnorm, new_scale

    def train_step(state: dict, batch: dict):
        state = _place(state, _state_pspecs(state, mesh), mesh)
        batch = _place(batch, meshlib.batch_pspecs(batch, mesh), mesh)
        master = state["master"] if state["master"] is not None else state["params"]
        m_leaves, rebuild = _flatten(master)
        b = next(iter(batch.values())).shape[0]
        src = groups[:_split(b // microbatch, mesh)]
        run = src[:1] if dry else src
        # The pinned cast on the owners: the gathers move storage bytes.
        storage = [_blockwise(x, lambda t: t.to(policy.param_storage)) for x in m_leaves]
        scale0 = _first(state["scale"].scale)  # replicated: every owner holds this value
        acc, loss, regions = megatron_grads(storage, rebuild, batch, scale0, src, run)
        # Gradients reduce-scattered into the master layout, in data-index
        # order (then model-rank order).
        grads = []
        for j, x in enumerate(m_leaves):
            parts = [(er, reg, piece) for e in src for r, er in enumerate(_rank_ents(mesh, e))
                     for reg, piece in _pieces(regions[r][j], acc[e if e in acc else run[0]][r][j])]
            g = sh.reduce_scatter(parts, x.sharding, x.shape, d_axes)
            if microbatch > 1:
                g = _blockwise(g, lambda t: t / microbatch)
            grads.append(_blockwise(g, lambda t: t / scale0.to(t.device)))
        flags = []
        for e in sh.entries(mesh):
            with on_entry(mesh, e):
                flags.append((e, torch.stack([torch.isfinite(g.blocks[e]).all()
                                              for g in grads]).all()))
        finite = sh.all_reduce(flags, op="all")
        new_state, gnorm, new_scale = update(state, m_leaves, grads, finite)
        metrics = {"loss": loss, "grad_norm": gnorm, "loss_scale": new_scale.scale,
                   "skipped": (~finite).to(f32)}
        return new_state, metrics

    return train_step


def _write_back(mesh, parts: list, spec: P, shape: tuple, n_src: int) -> Sharded:
    """The data indices' outputs (``[(entry, region, tensor)]``) laid out
    per ``spec``: each group's rows scattered to its entries (over every
    axis when one data index computed for all)."""
    axes = meshlib.model_axes(mesh) if n_src > 1 else tuple(mesh.axis_names)
    return sh.reduce_scatter(parts, NamedSharding(mesh, spec), shape, axes)


def _region(spec: P, shape: tuple, mesh, entry, n_src: int) -> tuple:
    """A data index's region of an output of ``shape``: its block along the
    dims ``spec`` shards over the data axes, the rest whole."""
    d = meshlib.data_axes(mesh)
    whole = tuple(slice(0, n) for n in shape)
    if n_src == 1:
        return whole
    blk = sh.block_slices(shape, spec, mesh, entry)
    parts = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(b if meshlib.part_axes(p) == d else w for b, w, p in zip(blk, whole, parts))


def _serve_groups(mesh, b: int):
    n_src = _split(b, mesh)
    src = _groups(mesh)[:n_src]
    return n_src, src, (src[:1] if _dry(mesh) else src)


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _gather_ranges(tree, mesh, src, run, cfg, plan):
    """Every data index's model ranks gather their ranges of ``tree``'s
    Sharded leaves (:func:`_rank_regions`, regions of each leaf's blocks,
    laid side by side);
    returns the regions per rank and leaf, and per computing data index
    each rank's gathered leaves."""
    leaves = tree_leaves(tree)
    keys = [k for k, _ in meshlib.key_paths(tree)]
    held = [sh.pieces(x) for x in leaves]
    regions = [[_rank_regions(k, x.shape, pl, cfg) for k, x in zip(keys, leaves)]
               for pl in plan]
    out = {}
    for e in src:
        got = []
        for r, er in enumerate(_rank_ents(mesh, e)):
            ranks = []
            for x, regs, h in zip(leaves, regions[r], held):
                parts = [sh.region_gather(x, er, reg, h) for reg in regs]
                if len(parts) == 1:
                    ranks.append(parts[0])
                else:
                    with on_entry(mesh, er):
                        ranks.append(torch.cat(parts, dim=-1))
            got.append(ranks)
            note_gathered(er, _nbytes(got[-1]))
        if e in run:
            out[e] = got
    return regions, out


def _logits_spec(mesh, b: int, v: int) -> P:
    return meshlib.fit_spec(P(meshlib.data_axes(mesh), "model"), (b, v), mesh)


def _serve_step(cfg, mesh, params, inputs: list, plan: list, run_group):
    """The split prefill over the mesh's lowering: ``params`` (laid out per
    ``param_pspec``) and ``inputs`` (Sharded over the batch, or whole); each
    computing data index's model ranks gather their ranges (``plan``) and
    their copy of its rows, and ``run_group(e, trees, rows)`` computes the
    data index's logits (and cache) on its first entry; returns ``(logits,
    cache)`` (cache None if ``run_group`` gives none), each data index's
    rows sent back to its group: the logits per ``P(data, "model")`` and the
    cache per ``cache_pspec``, fitted."""
    b = inputs[0].shape[0]
    n_src, src, run = _serve_groups(mesh, b)
    ranges = _gather_ranges(params, mesh, src, run, cfg, plan)[1]
    axes = meshlib.model_axes(mesh)  # a cache's features lie over `model`
    results, group_log = {}, []
    for e in src:
        rows = _rank_rows(mesh, e, inputs, axes)
        if e in run:
            with recording_collectives(group_log):
                out = run_group(e, ranges[e], rows)
            results[e] = out if isinstance(out, tuple) else (out, None)
        else:
            replay_collectives(group_log, _moved_to(mesh, e))
    results = {e: results.get(e, results[run[0]]) for e in src}
    shape = (b, results[src[0]][0].shape[-1])
    spec = _logits_spec(mesh, *shape)
    logits = _write_back(mesh, [(e, _region(spec, shape, mesh, e, n_src), results[e][0])
                                for e in src], spec, shape, n_src)
    if results[src[0]][1] is None:
        return logits, None
    return logits, _cache_back(mesh, {e: results[e][1] for e in src}, src, n_src)


def _rank_rows(mesh, e, inputs: list, axes) -> list:
    """Each of ``e``'s model ranks' copy of its data index's rows of
    ``inputs``."""
    rows = []
    for er in _rank_ents(mesh, e):
        rows.append([sh.all_gather(x, er, axes)[0] for x in inputs])
        note_gathered(er, _nbytes(rows[-1]))
    return rows


def _megatron_prefill(cfg, policy, mesh, seq_shard: bool, collect_cache: bool,
                      cache_len: int, rebuild_params, rebuild_batch):
    """``(plan, run_group)`` for :func:`_serve_step`: a data index's prefill
    over its model group (:func:`repro_torch.models.transformer.forward_group`),
    the last position's vocab-parallel logits gathered along the vocab onto
    its first entry and, with ``collect_cache``, the ranks' KV heads and
    recurrent states' channels assembled there into the decode cache."""
    act_to = act_dtype(policy.compute)
    plan = meshlib.compute_plan(cfg, meshlib.model_size(mesh))

    def run_group(e, ranks, rows):
        batches = [_fill_positions(cfg, rebuild_batch(r)) for r in rows]
        run = _group_run(cfg, mesh, e, plan, _seq_len(cfg, batches[0]), seq_shard, act_to)
        views = [tf.params_view(cfg, rebuild_params(leaves), heads=(pl.n_heads, pl.n_kv))
                 for leaves, pl in zip(ranks, plan)]
        out = tf.forward_group(views, batches, run, collect=collect_cache)
        hs, states = out[0], (out[2] if collect_cache else None)
        parts = tf.lm_logits_group(views, [h[:, -1] for h in hs], run)
        dev = run.grp.device(0)
        with run.grp.on(0):
            logits = torch.cat([p.to(dev) for p in parts], dim=-1)
        note_collective("all-gather", {run.grp.ents[0]: _nbytes(parts[1:])})
        if not collect_cache:
            return logits
        return logits, _assemble_cache(cfg, run, states, batches[0], cache_len,
                                       policy.state_storage)

    return plan, run_group


def _first_kv_heads(plan: list) -> list:
    """Per rank the KV heads ``(lo, hi)`` that it is the first to compute
    (None where it computes no new one, or has no head): the cache takes
    each KV head from the first rank that computed it."""
    out, done = [], 0
    for pl in plan:
        lo, hi = max(pl.kv_heads[0], done), pl.kv_heads[1]
        out.append((lo, hi) if pl.n_heads and hi > lo else None)
        if pl.n_heads:
            done = max(done, hi)
    return out


def _assemble_cache(cfg, run, states: list, batch: dict, cache_len: int, dtype):
    """The decode cache of a data index's rows on its first entry from each
    rank's share per layer (:func:`repro_torch.models.transformer.forward_group`),
    packed as the single-device prefill packs it: an attention layer's
    ``(k, v)`` of the rank's KV heads (a head several ranks computed is
    taken from the first), a recurrent layer's state on the rank's channels
    laid side by side in rank order."""
    dev = run.grp.device(0)
    b, s = batch["positions"].shape[:2]
    pos = batch["positions"]
    qpos = (pos[..., 0] if cfg.mrope_sections is not None else pos)[0]
    hd = cfg.head_dim
    with run.grp.on(0):
        cache = tf.init_cache(cfg, b, cache_len, dtype, dev, cap_at_window=False)
        for i, per_rank in enumerate(states):
            lc = tf._layer_cache(cfg, cache, i)
            if "kv" not in lc:  # Mamba's conv [B, K-1, Di] and ssm [B, Di, N]; the RG-LRU's
                (part, _), = lc.items()  # h [B, W] and conv [B, 3, W]: channels by rank
                whole = {name: torch.cat([st[name].to(dev) for st in per_rank],
                                         dim=-2 if name == "ssm" else -1)
                         for name in per_rank[0]}
                note_collective("all-gather", {run.grp.ents[0]: sum(
                    _nbytes(st.values()) for st in per_rank[1:])})
                tf._copy_state(lc[part], whole)
                continue
            first = next(kv for kv in per_rank if kv is not None)
            k = torch.empty((b, s, cfg.n_kv_heads, hd), dtype=first[0].dtype, device=dev)
            v = torch.empty((b, s, cfg.n_kv_heads, hd), dtype=first[1].dtype, device=dev)
            moved = 0
            for pl, kv, heads in zip(run.plan, per_rank, _first_kv_heads(run.plan)):
                if heads is None:
                    continue
                lo, hi = heads
                sl = slice(lo - pl.kv_heads[0], hi - pl.kv_heads[0])
                k[:, :, lo:hi] = kv[0][:, :, sl].to(dev)
                v[:, :, lo:hi] = kv[1][:, :, sl].to(dev)
                if pl.rank:
                    moved += _nbytes([kv[0][:, :, sl], kv[1][:, :, sl]])
            note_collective("all-gather", {run.grp.ents[0]: moved})
            tf._pack_kv((k, v), qpos, tf._window(cfg), lc["kv"])
    return cache


def _sharded_prefill_step(cfg, policy, mesh, seq_shard: bool, collect_cache: bool,
                          cache_len: int):
    def prefill_step(params, batch: dict):
        params = _place(params, meshlib.tree_pspecs(params, mesh), mesh)
        batch = _place(batch, meshlib.batch_pspecs(batch, mesh), mesh)
        leaves, rebuild = _flatten(batch)
        plan, run_group = _megatron_prefill(cfg, policy, mesh, seq_shard, collect_cache,
                                            cache_len, _flatten(params)[1], rebuild)
        logits, cache = _serve_step(cfg, mesh, params, leaves, plan, run_group)
        return (logits, cache) if collect_cache else logits

    return prefill_step


def _cache_back(mesh, caches: dict, src, n_src: int):
    """Every data index's rows of a decode cache laid out per
    ``cache_pspec`` (fitted to the whole cache's shape)."""
    first = caches[src[0]]
    _, rebuild = _flatten(first)
    per = {e: tree_leaves(caches[e]) for e in src}
    out = []
    for j, (keys, leaf) in enumerate(meshlib.key_paths(first)):
        raw = meshlib.cache_pspec(keys, leaf, mesh)
        shape = _global_shape(tuple(leaf.shape), raw, mesh, n_src)
        spec = meshlib.fit_spec(raw, shape, mesh)
        parts = [(e, _region(spec, shape, mesh, e, n_src), per[e][j]) for e in src]
        out.append(_write_back(mesh, parts, spec, shape, n_src))
    return rebuild(out)


def _global_shape(local: tuple, spec: P, mesh, n_src: int) -> tuple:
    """A data index's output shape grown back along its data-sharded dims."""
    d = meshlib.data_axes(mesh)
    parts = tuple(spec) + (None,) * (len(local) - len(spec))
    return tuple(n * n_src if meshlib.part_axes(p) == d else n for n, p in zip(local, parts))


class _CacheShares:
    """A data index's rows of the decode cache (Sharded per ``cache_pspec``,
    updated in place) as its model ranks compute with them: the ``cache``
    of :func:`repro_torch.models.transformer.decode_group`.
    ``share(i, r)`` assembles on rank ``r``'s entry its region of layer
    ``i`` from the blocks that hold it (``sharded.region_gather``): an
    attention layer's ``k`` and ``v`` of the rank's KV heads over every slot
    (along ``Dh`` under the ``"headdim"`` layout, along the slots under
    ``"seq"``) with the entry's own replica of the slots' ``pos``, or the
    rank's channels of a recurrent state; it is dropped after the layer.
    ``commit(i, r, share)`` writes what the rank changed into every block
    that holds part of it (``sharded.region_write``): the new token's slot
    of the KV heads the rank is the first to compute
    (:func:`_first_kv_heads`), or its channels of the new state."""

    def __init__(self, cfg, cache, ents: tuple, plan: list, rows: slice, pos: int):
        self.cfg, self.cache, self.ents, self.plan, self.rows, self.pos = (
            cfg, cache, ents, plan, rows, pos)
        self.held: dict = {}
        self.gathered = [0] * len(ents)  # bytes each rank assembled
        self.first = _first_kv_heads(plan)

    def _layer(self, i: int):
        """Layer ``i``'s kind of entry, its leaves, and the leading slice of
        a stacked cache."""
        if self.cfg.homogeneous:
            (part, leaves), = self.cache.items()
            return part, leaves, (slice(i, i + 1),)
        (part, leaves), = self.cache[i].items()
        return part, leaves, ()

    def _region(self, part: str, name: str, x: Sharded, pl, lead: tuple) -> tuple:
        rest = [slice(0, n) for n in x.shape[len(lead):]]
        rest[0] = self.rows
        if part == "kv":  # [B, C, Hkv, Dh]: its KV heads
            rest[2] = slice(*pl.kv_heads)
        else:  # Mamba's conv [B, K-1, Di] and ssm [B, Di, N]; the RG-LRU's h and conv
            rest[1 if name == "ssm" else -1] = slice(*(pl.inner if part == "ssm" else pl.lru))
        return lead + tuple(rest)

    def _pieces(self, x: Sharded) -> dict:
        if id(x) not in self.held:
            self.held[id(x)] = sh.pieces(x)
        return self.held[id(x)]

    def share(self, i: int, r: int) -> dict:
        part, leaves, lead = self._layer(i)
        er = self.ents[r]
        out = {}
        for name, x in leaves.items():
            if name == "pos":  # replicated: the entry's own copy, the new slot set
                out[name] = x.blocks[er][i] if lead else x.blocks[er]
                continue
            t = sh.region_gather(x, er, self._region(part, name, x, self.plan[r], lead),
                                 self._pieces(x))
            note_gathered(er, t.numel() * t.element_size())
            self.gathered[r] += t.numel() * t.element_size()
            out[name] = t[0] if lead else t
        return out

    def commit(self, i: int, r: int, share: dict) -> None:
        part, leaves, lead = self._layer(i)
        pl, er = self.plan[r], self.ents[r]
        if part == "kv" and self.first[r] is None:
            return
        for name, x in leaves.items():
            if name == "pos":
                continue
            region = list(self._region(part, name, x, pl, lead))
            t = share[name]
            if part == "kv":  # the new slot of the heads it is the first to compute
                lo, hi = self.first[r]
                slot = self.pos % t.shape[1]
                t = t[:, slot:slot + 1, lo - pl.kv_heads[0]:hi - pl.kv_heads[0]]
                region[len(lead) + 1] = slice(slot, slot + 1)
                region[len(lead) + 2] = slice(lo, hi)
            sh.region_write(x, er, tuple(region), t[None] if lead else t, self._pieces(x))


def _set_pos(cfg, cache, pos: int) -> None:
    """``pos`` into slot ``pos mod C`` of every attention layer's ``pos`` on
    every entry (a replicated leaf, each entry's own copy: no collective)."""
    if cfg.homogeneous:
        xs = [cache["kv"]["pos"]] if "kv" in cache else []
    else:
        xs = [entry["kv"]["pos"] for entry in cache if "kv" in entry]
    for x in xs:  # [L, C] stacked (every layer at once), or one layer's [C]
        for e in sh.entries(x.mesh):
            with on_entry(x.mesh, e):
                blk = x.blocks[e]
                blk[..., pos % blk.shape[-1]] = pos


def _sharded_decode_step(cfg, policy, mesh):
    """``decode(params, cache, token, pos)`` -> ``(logits, cache)`` over the
    mesh's lowering, split over ``model``: params per ``param_pspec``, the
    cache per ``cache_pspec`` and updated in place (the reference donates
    it). Each computing data index's model ranks gather their ranges
    (:func:`_gather_ranges`, prefill's plan) and their copy of its token
    rows, and run :func:`repro_torch.models.transformer.decode_group`, each
    layer's cache assembled per rank and written back
    (:class:`_CacheShares`); each rank's vocab range of the logits goes to
    the blocks of ``P(data, "model")``, fitted."""
    act_to = act_dtype(policy.compute)
    plan = meshlib.compute_plan(cfg, meshlib.model_size(mesh))

    def decode(params, cache, token, pos):
        params = _place(params, meshlib.tree_pspecs(params, mesh), mesh)
        cache = _place(cache, meshlib.tree_pspecs(cache, mesh, rule=meshlib.cache_pspec), mesh)
        token = _place(token, meshlib.batch_pspecs(token, mesh), mesh)
        pos = int(pos)
        _set_pos(cfg, cache, pos)
        b, v = token.shape[0], cfg.vocab_size
        n_src, src, run = _serve_groups(mesh, b)
        rebuild = _flatten(params)[1]
        ranges = _gather_ranges(params, mesh, src, run, cfg, plan)[1]
        axes = meshlib.model_axes(mesh)
        results, group_log, shares = {}, [], None
        for gi, e in enumerate(src):
            tokens = [rows[0] for rows in _rank_rows(mesh, e, [token], axes)]
            if e not in run:  # a dry-run's data index: what the computing one did
                replay_collectives(group_log, _moved_to(mesh, e))
                for er, n in zip(_rank_ents(mesh, e), shares.gathered):
                    note_gathered(er, n)
                continue
            bd = b // n_src
            shares = _CacheShares(cfg, cache, _rank_ents(mesh, e), plan,
                                  slice(gi * bd, (gi + 1) * bd), pos)
            views = [tf.params_view(cfg, rebuild(lv), heads=(pl.n_heads, pl.n_kv))
                     for lv, pl in zip(ranges[e], plan)]
            with recording_collectives(group_log):
                results[e] = tf.decode_group(views, tokens, pos,
                                             _group_run(cfg, mesh, e, plan, 1, False, act_to),
                                             shares)
        spec = _logits_spec(mesh, b, v)
        parts = []
        for e in src:
            rows = _region(spec, (b, v), mesh, e, n_src)[0]
            for er, pl, lg in zip(_rank_ents(mesh, e), plan, results.get(e, results[run[0]])):
                parts.append((er, (rows, slice(*pl.vocab)), lg))
        return _write_back(mesh, parts, spec, (b, v), n_src), cache

    return decode


# -- cell assembly ---------------------------------------------------------------------


@dataclasses.dataclass
class Task:
    """A cell: ``fn`` (the step), ``args`` (its inputs as ``meta`` tensor
    trees, one per positional argument), and the shardings of its
    arguments and outputs (trees of
    :class:`~repro_torch.launch.mesh.NamedSharding`)."""

    name: str
    kind: str  # train | prefill | decode
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    seq_shard: bool = True
    model_compute: str = "megatron"  # split over `model` (launch/mesh.model_compute)

    def sharded(self) -> Callable:
        """The step over the mesh's lowering, the counterpart of the
        reference's ``jitted()``: it lays tensor arguments out per
        ``in_shardings`` (``jit``'s ``device_put``; Sharded ones are kept,
        or re-laid out), and its outputs come laid out per
        ``out_shardings`` (metrics, replicated scalars, as tensors on the
        mesh's first device)."""
        return self.fn


def build_task(cfg: ArchConfig, shape: ShapeConfig, mesh, policy: PrecisionPolicy | str = "fp16",
               *, seq_shard: bool = True, microbatch: int | None = None,
               ce_chunk: int = 512) -> Task:
    """Assemble the (arch x shape) cell on ``mesh`` for the dry-run and the
    drivers: the reference's tasks (training at the default
    ``AdamWConfig``), shardings and meta inputs."""
    if isinstance(policy, str):
        policy = get_policy(policy)
    d = meshlib.data_axes(mesh)
    batch_specs = input_specs(cfg, shape)
    batch_shard = meshlib.named(meshlib.batch_pspecs(batch_specs, mesh), mesh)
    param_specs = tf.params_tree(tf.init_params(cfg, policy, device="meta"))
    param_shard = meshlib.named(meshlib.tree_pspecs(param_specs, mesh), mesh)
    name = f"{cfg.name}:{shape.name}"
    b = shape.global_batch
    split = meshlib.model_compute(cfg)

    if shape.kind == "train":
        step = make_train_step(cfg, policy, mesh=mesh, seq_shard=seq_shard,
                               microbatch=microbatch or 1, ce_chunk=ce_chunk)
        state_specs = train_state_specs(cfg, policy)
        state_shard = meshlib.named(_state_pspecs(state_specs, mesh), mesh)
        metric_shard = {k: NamedSharding(mesh, P()) for k in
                        ("loss", "grad_norm", "loss_scale", "skipped")}
        return Task(name, "train", step, (state_specs, batch_specs),
                    (state_shard, batch_shard), (state_shard, metric_shard), (0,), seq_shard,
                    split)

    logits_shard = NamedSharding(mesh, _logits_spec(mesh, b, cfg.vocab_size))
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, policy, mesh=mesh, seq_shard=seq_shard)
        return Task(name, "prefill", step, (param_specs, batch_specs),
                    (param_shard, batch_shard), logits_shard, (), seq_shard, split)

    step = make_decode_step(cfg, policy, mesh=mesh)
    cache_specs = tf.init_cache(cfg, b, shape.seq_len, policy.state_storage, "meta")
    cache_shard = meshlib.named(
        meshlib.tree_pspecs(cache_specs, mesh, rule=meshlib.cache_pspec), mesh)
    token_shard = NamedSharding(mesh, meshlib.fit_spec(P(d, None), (b, 1), mesh))
    return Task(name, "decode", step,
                (param_specs, cache_specs, batch_specs["token"], batch_specs["pos"]),
                (param_shard, cache_shard, token_shard, NamedSharding(mesh, P())),
                (logits_shard, cache_shard), (1,), seq_shard, split)
