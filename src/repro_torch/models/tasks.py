"""Step functions: train, prefill and decode (``repro/models/tasks.py``).

``make_*_step`` return plain functions of the model (or the train state)
and its inputs. There is no mesh and no sharding yet: ``build_task``,
``input_specs``, ``train_state_specs`` and ``make_train_step(mesh=)`` come
with the LM mesh (ROADMAP A12d).

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
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import act_dtype, dense
from repro_torch.optim.adamw import (
    AdamWConfig, adamw_init, adamw_update, scale_init, scale_update,
)
from repro_torch.precision import PrecisionPolicy, get_policy
from repro_torch.precision.policy import _flatten, tree_leaves, tree_map

__all__ = ["make_prefill_step", "make_decode_step", "make_train_step", "init_train_state",
           "chunked_ce"]

f32 = torch.float32


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
    b, s, d = h.shape
    c = min(chunk, s)
    pad = -s % c
    mask_sum = torch.sum(mask)
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    total = torch.zeros((), dtype=f32, device=h.device)
    for i in range(0, s + pad, c):
        total = total + checkpoint(_ce_chunk, h[:, i:i + c], w, targets[:, i:i + c],
                                   mask[:, i:i + c], act_to, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / torch.clamp(mask_sum, min=1.0)


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


# -- step functions ----------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, policy: PrecisionPolicy, *, remat: bool = True,
                    microbatch: int = 1, opt_cfg: AdamWConfig = AdamWConfig(),
                    aux_weight: float = 0.01, ce_chunk: int = 512):
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
    plain versions on the CPU."""
    if isinstance(policy, str):
        policy = get_policy(policy)
    act_to = act_dtype(policy.compute)

    def loss_fn(master, batch, scale):
        params = tree_map(lambda x: x.to(policy.param_storage), master)
        model = tf.params_view(cfg, params)
        full = _fill_positions(cfg, batch)
        h, aux = tf.forward(model, full, act_to=act_to, remat=remat)
        tokens = full["tokens"]
        if cfg.frontend == "vision":
            h = h[:, cfg.n_patches:]  # the loss runs over the text positions only
        targets = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
        mask = torch.cat([torch.ones(tokens[:, 1:].shape, dtype=f32, device=tokens.device),
                          torch.zeros(tokens[:, :1].shape, dtype=f32, device=tokens.device)],
                         dim=1)
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


def make_prefill_step(cfg: ArchConfig, policy: PrecisionPolicy, *,
                      collect_cache: bool = False, cache_len: int = 0):
    """``prefill_step(model, batch)`` -> last-position logits ``[B, V]``
    (and, with ``collect_cache``, the decode cache of ``cache_len`` slots
    in the policy's state storage dtype). Activations run in the policy's
    compute dtype, as the reference's step sets them."""
    act_to = act_dtype(policy.compute)

    def prefill_step(model: tf.Transformer, batch: dict):
        full = _fill_positions(cfg, batch)
        out = tf.forward(model, full, collect_cache=collect_cache, cache_len=cache_len,
                         cache_dtype=policy.state_storage, act_to=act_to)
        if collect_cache:
            h, _, cache = out
            return tf.lm_logits(model, h[:, -1], act_to), cache
        return tf.lm_logits(model, out[0][:, -1], act_to)

    return prefill_step


def make_decode_step(cfg: ArchConfig, policy: PrecisionPolicy):
    """``decode_fn(model, cache, token, pos)`` -> ``(logits, cache)``,
    activations in the policy's compute dtype."""
    act_to = act_dtype(policy.compute)

    def decode_fn(model: tf.Transformer, cache: dict, token: torch.Tensor, pos: int):
        return tf.decode_step(model, cache, token, pos, act_to)

    return decode_fn
