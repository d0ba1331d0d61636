"""AdamW with fp32 master weights, global-norm clipping, dynamic loss scaling.

The reference's ``repro/optim/adamw.py`` on torch tensors: the deployed
parameters live in the storage dtype (fp16), the optimizer keeps f32
masters and moments, and fp16 gradients are protected by dynamic loss
scaling. Trees are nested dicts of tensors; their leaves are visited in
the reference's flatten order (dict keys sorted), which fixes the order in
which :func:`global_norm` adds the per-leaf sums. Every update is
branchless (``torch.where`` on ``skip``), so a step never waits on the
card. The arithmetic follows the reference operation for operation; its
``b ** step`` is XLA CPU's ``powf``, taken here as the f64 power rounded
to f32 (the same value but in rare hard cases).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.precision.policy import _flatten, tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "ScaleState", "adamw_init", "adamw_update",
           "scale_init", "scale_update", "global_norm", "StepScalars", "step_scalars",
           "update_leaf"]

f32 = torch.float32


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100


class OptState(NamedTuple):
    m: dict
    v: dict
    step: torch.Tensor  # int32 scalar


class ScaleState(NamedTuple):
    """Dynamic loss scaling (fp16 policy)."""

    scale: torch.Tensor  # current loss scale (f32)
    good_steps: torch.Tensor  # consecutive finite steps (int32)


def adamw_init(master: dict) -> OptState:
    leaves = tree_leaves(master)
    dev = leaves[0].device if leaves else None
    zeros = lambda: tree_map(lambda x: torch.zeros(x.shape, dtype=f32, device=x.device), master)
    return OptState(m=zeros(), v=zeros(), step=torch.zeros((), dtype=torch.int32, device=dev))


def scale_init(initial: float | None, device=None) -> ScaleState:
    return ScaleState(
        scale=torch.tensor(initial if initial else 1.0, dtype=f32, device=device),
        good_steps=torch.zeros((), dtype=torch.int32, device=device),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, the per-leaf f32 sums added
    in leaf order."""
    sq = sum(torch.sum(torch.square(x.to(f32))) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def _lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1).to(f32) / float(cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def _pow_f32(base: float, e: torch.Tensor) -> torch.Tensor:
    """``float32(base) ** e`` (``e`` float32), rounded once from f64."""
    b = torch.tensor(base, dtype=f32).double()
    return torch.pow(b.to(e.device), e.double()).to(f32)


class StepScalars(NamedTuple):
    """What every leaf's update shares: the clip divisor, the new step
    count, the learning rate and the two bias corrections."""

    denom: torch.Tensor
    step: torch.Tensor
    lr: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor


def step_scalars(cfg: AdamWConfig, opt_step: torch.Tensor, gnorm: torch.Tensor) -> StepScalars:
    """The scalars of one step from the optimizer's step count and the
    global gradient norm."""
    denom = torch.clamp(gnorm / cfg.clip_norm, min=1.0)
    step = opt_step + 1
    lr = _lr_at(cfg, step)
    stepf = step.to(f32)
    return StepScalars(denom, step, lr, 1.0 - _pow_f32(cfg.b1, stepf),
                       1.0 - _pow_f32(cfg.b2, stepf))


def update_leaf(cfg: AdamWConfig, sc: StepScalars, g, m, v, p,
                skip: torch.Tensor | None = None):
    """``(m', v', p')`` of one leaf (or one block of it: the update is
    elementwise), frozen where ``skip``."""
    g = g.to(f32) / sc.denom
    m2 = cfg.b1 * m + (1.0 - cfg.b1) * g
    v2 = cfg.b2 * v + (1.0 - cfg.b2) * g * g
    mh = m2 / sc.c1
    vh = v2 / sc.c2
    p2 = p - sc.lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p)
    if skip is not None:
        m2, v2, p2 = (torch.where(skip, old, new) for new, old in ((m2, m), (v2, v), (p2, p)))
    return m2, v2, p2


def adamw_update(cfg: AdamWConfig, grads: dict, opt: OptState, master: dict, *,
                 skip: torch.Tensor | None = None) -> tuple[dict, OptState, torch.Tensor]:
    """One AdamW step on the f32 masters. ``skip`` (a bool scalar tensor:
    nonfinite grads under loss scaling) freezes everything. Returns
    ``(master', opt', grad_norm)``."""
    gnorm = global_norm(grads)
    sc = step_scalars(cfg, opt.step, gnorm)
    flat_g, rebuild = _flatten(grads)
    out = [update_leaf(cfg, sc, g, m, v, p, skip) for g, m, v, p in
           zip(flat_g, tree_leaves(opt.m), tree_leaves(opt.v), tree_leaves(master))]
    m2, v2, p2 = (rebuild([o[i] for o in out]) for i in range(3))
    step = sc.step
    if skip is not None:
        step = torch.where(skip, opt.step, step)
    return p2, OptState(m=m2, v=v2, step=step), gnorm


def scale_update(s: ScaleState, finite: torch.Tensor, *, growth_interval: int = 2000,
                 factor: float = 2.0, max_scale: float = 2.0**24) -> ScaleState:
    """Dynamic scaler: halve on overflow, double after N clean steps."""
    grow = s.good_steps + 1 >= growth_interval
    new_scale = torch.where(
        finite,
        torch.where(grow, torch.clamp(s.scale * factor, max=max_scale), s.scale),
        torch.clamp(s.scale / factor, min=1.0),
    )
    zero = torch.zeros_like(s.good_steps)
    new_good = torch.where(finite, torch.where(grow, zero, s.good_steps + 1), zero)
    return ScaleState(scale=new_scale, good_steps=new_good.to(torch.int32))
