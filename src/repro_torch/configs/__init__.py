"""Configurations: the paper's Synfire nets and the LM substrate's
architectures.

The LM registry names the reference's ten architectures; the four
``family="dense"`` ones are ported, and :func:`get_arch` raises
``NotImplementedError`` for the other six (ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    ArchConfig,
    HybridConfig,
    MoEConfig,
    SSMConfig,
    count_params,
)
from repro_torch.configs.synfire4 import (
    SYNFIRE4,
    SYNFIRE4_MINI,
    SYNFIRE4_X10,
    SynfireConfig,
    build_synfire,
    scale_synfire,
)
from repro_torch.core.network import _unported

_MODULES = {
    "qwen2.5-14b": "qwen2_5_14b",
    "minitron-8b": "minitron_8b",
    "smollm-360m": "smollm_360m",
    "stablelm-12b": "stablelm_12b",
}
# The reference's other architectures, whose families are not ported yet.
_UNPORTED = {
    "falcon-mamba-7b": "ssm", "musicgen-large": "audio", "qwen2-vl-2b": "vlm",
    "recurrentgemma-2b": "hybrid", "granite-moe-1b-a400m": "moe",
    "qwen2-moe-a2.7b": "moe",
}

ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    if name in _UNPORTED:
        raise _unported(f"{name} (family {_UNPORTED[name]!r})", "A12")
    try:
        mod = _MODULES[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; have "
                       f"{sorted([*_MODULES, *_UNPORTED])}") from e
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def reduce_arch(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: same family/topology, tiny dimensions."""
    kv_ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_heads = 4
    n_kv = max(1, n_heads // kv_ratio)
    changes: dict = dict(
        name=cfg.name + "-reduced",
        n_layers=3 if cfg.hybrid is not None else 2,
        d_model=64,
        n_heads=n_heads, n_kv_heads=n_kv, head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512,
        n_patches=8,
    )
    if cfg.mrope_sections is not None:
        changes["mrope_sections"] = (4, 2, 2)  # sums to head_dim/2
    if cfg.moe is not None:
        changes["moe"] = MoEConfig(
            n_experts=min(8, cfg.moe.n_experts), top_k=2, d_expert=32,
            n_shared=cfg.moe.n_shared and 1, d_shared=cfg.moe.d_shared and 64)
    if cfg.ssm is not None:
        changes["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
    if cfg.hybrid is not None:
        changes["hybrid"] = HybridConfig(period=3, window=32, lru_width=64)
    return dataclasses.replace(cfg, **changes)


__all__ = ["ARCH_NAMES", "ArchConfig", "HybridConfig", "MoEConfig", "SSMConfig",
           "count_params", "get_arch", "reduce_arch",
           "SYNFIRE4", "SYNFIRE4_MINI", "SYNFIRE4_X10", "SynfireConfig",
           "build_synfire", "scale_synfire"]
