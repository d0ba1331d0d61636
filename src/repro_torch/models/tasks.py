"""Step functions for serving: prefill and decode (``repro/models/tasks.py``).

There is no mesh, no sharding and no train step in the port yet;
``make_*_step`` return plain functions of the model and its inputs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import act_dtype
from repro_torch.precision import PrecisionPolicy

__all__ = ["make_prefill_step", "make_decode_step"]


def _fill_positions(cfg: ArchConfig, batch: dict) -> dict:
    """Materialise default positions ``arange(S)`` per row when the batch
    does not carry them."""
    if "positions" in batch:
        return batch
    b, s = batch["tokens"].shape
    pos = torch.arange(s, dtype=torch.int32, device=batch["tokens"].device)
    return dict(batch, positions=pos.expand(b, s).contiguous())


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
            h, cache = out
            return tf.lm_logits(model, h[:, -1], act_to), cache
        return tf.lm_logits(model, out[:, -1], act_to)

    return prefill_step


def make_decode_step(cfg: ArchConfig, policy: PrecisionPolicy):
    """``decode_fn(model, cache, token, pos)`` -> ``(logits, cache)``,
    activations in the policy's compute dtype."""
    act_to = act_dtype(policy.compute)

    def decode_fn(model: tf.Transformer, cache: dict, token: torch.Tensor, pos: int):
        return tf.decode_step(model, cache, token, pos, act_to)

    return decode_fn
