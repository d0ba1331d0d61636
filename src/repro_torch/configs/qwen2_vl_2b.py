"""qwen2-vl-2b — VLM backbone with M-RoPE [arXiv:2409.12191].

28L, d_model=1536, 12H (GQA kv=2), d_ff=8960, vocab=151936.
The vision tower is a stub: ``input_specs`` provides precomputed patch
embeddings (256-patch prefix) + 3-D (t, h, w) positions for M-RoPE.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
    frontend="vision",
    n_patches=256,
)
