"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L, d_model=2048, 32H MHA, d_ff=8192, vocab=2048 (EnCodec codebook).
The EnCodec frontend is a stub: the backbone consumes the token stream
directly; positions are sinusoidal-absolute (no RoPE).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp="gelu",
    norm="layernorm",
    rotary_pct=0.0,  # sinusoidal absolute positions
)
