"""Configurations: the paper's Synfire nets and the LM substrate's
architectures.

The LM registry holds the reference's ten architectures, in its order:
the dense GQA transformers, two MoE, the Mamba SSM, the RG-LRU hybrid
with local attention, the audio decoder (sinusoidal positions) and the
VLM (M-RoPE and a patch-embedding prefix).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    ArchConfig,
    HybridConfig,
    MoEConfig,
    SHAPES,
    SSMConfig,
    ShapeConfig,
    count_active_params,
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

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "musicgen-large": "musicgen_large",
    "qwen2.5-14b": "qwen2_5_14b",
    "minitron-8b": "minitron_8b",
    "smollm-360m": "smollm_360m",
    "stablelm-12b": "stablelm_12b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
}

ARCH_NAMES = tuple(_MODULES)


def get_arch(name: str) -> ArchConfig:
    try:
        mod = _MODULES[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_MODULES)}") from e
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


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


__all__ = ["ARCH_NAMES", "ArchConfig", "HybridConfig", "MoEConfig", "SHAPES", "SSMConfig",
           "ShapeConfig", "count_active_params", "count_params", "get_arch", "get_shape",
           "reduce_arch",
           "SYNFIRE4", "SYNFIRE4_MINI", "SYNFIRE4_X10", "SynfireConfig",
           "build_synfire", "scale_synfire"]
