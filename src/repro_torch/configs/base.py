"""Architecture configuration schema for the LM substrate.

A copy of the reference's ``repro/configs/base.py`` schema (the port keeps
its own, imports nothing of ``repro``). Every architecture is an
:class:`ArchConfig`. Parameters and KV caches are held in the precision
policy's storage dtype (fp16 under the paper's policy) and decoded to f32
at the math.
"""
from __future__ import annotations

import dataclasses

__all__ = ["MoEConfig", "SSMConfig", "HybridConfig", "ArchConfig", "ShapeConfig", "SHAPES",
           "count_params", "count_active_params"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden dim
    n_shared: int = 0  # shared experts (qwen2-moe style)
    d_shared: int = 0  # shared-expert hidden dim (total)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style: layer i is local attention iff (i+1) % period == 0
    (1:2 attention:recurrent), else RG-LRU."""

    period: int = 3
    window: int = 2048
    lru_width: int = 0  # 0 -> d_model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    mlp: str = "swiglu"  # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    mrope_sections: tuple[int, int, int] | None = None  # M-RoPE (t, h, w)
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    # long_500k eligibility: sub-quadratic sequence mixing only.
    subquadratic: bool = False
    # modality frontend stub: 'none' | 'vision' (precomputed patch embeds)
    frontend: str = "none"
    n_patches: int = 256  # vlm prefix length (stub patches)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_kind(self, i: int) -> str:
        """Sequence-mixer of layer i: 'attn' | 'ssm' | 'rglru'."""
        if self.family == "ssm":
            return "ssm"
        if self.hybrid is not None:
            return "attn" if (i + 1) % self.hybrid.period == 0 else "rglru"
        return "attn"

    @property
    def homogeneous(self) -> bool:
        kinds = {self.layer_kind(i) for i in range(self.n_layers)}
        return len(kinds) == 1


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# -- analytic parameter counts (MODEL_FLOPS = 6·N·D) ---------------------------


def _mlp_params(cfg: ArchConfig, d_ff: int) -> int:
    if cfg.mlp in ("swiglu", "geglu"):
        return 3 * cfg.d_model * d_ff
    return 2 * cfg.d_model * d_ff


def _attn_params(cfg: ArchConfig) -> int:
    return (cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
            + cfg.q_dim * cfg.d_model)


def _layer_params(cfg: ArchConfig, i: int, *, active_only: bool = False) -> int:
    kind = cfg.layer_kind(i)
    n = 0
    if kind == "attn":
        n += _attn_params(cfg)
    elif kind == "ssm":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        dt_rank = s.dt_rank or -(-cfg.d_model // 16)
        n += cfg.d_model * 2 * d_in  # in_proj
        n += d_in * s.d_conv  # conv
        n += d_in * (dt_rank + 2 * s.d_state)  # x_proj
        n += dt_rank * d_in + d_in  # dt_proj
        n += d_in * s.d_state + d_in  # A_log, D
        n += d_in * cfg.d_model  # out_proj
    elif kind == "rglru":
        h = cfg.hybrid
        w = h.lru_width or cfg.d_model
        n += 2 * cfg.d_model * w + 2 * w * 4 + w * cfg.d_model  # x/gate proj, conv4, out
        n += 2 * w  # recurrence gates
    if kind != "ssm":
        if cfg.moe is not None:
            m = cfg.moe
            n += cfg.d_model * m.n_experts  # router
            per_exp = _mlp_params(cfg, m.d_expert)
            n += (m.top_k if active_only else m.n_experts) * per_exp
            if m.n_shared:
                n += _mlp_params(cfg, m.d_shared)
        else:
            n += _mlp_params(cfg, cfg.d_ff)
    n += 2 * cfg.d_model  # norms
    return n


def count_params(cfg: ArchConfig) -> int:
    """Parameters of the embedding, the LM head (untied) and the layers;
    the final norm's scale is not counted, as in the reference."""
    n = cfg.vocab_size * cfg.d_model  # embed
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model  # lm head
    n += sum(_layer_params(cfg, i) for i in range(cfg.n_layers))
    return n



def count_active_params(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE: only top-k experts)."""
    n = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    n += sum(_layer_params(cfg, i, active_only=True) for i in range(cfg.n_layers))
    return n
