"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1:2 [arXiv:2402.19427].

26L, d_model=2560, 10H (MQA kv=1, head_dim=256), d_ff=7680 (GeGLU),
vocab=256000. Layer i is local attention (window 2048) iff (i+1) %% 3 == 0.
Sub-quadratic: long_500k runs (bounded window + O(1) recurrent state).
"""
from repro_torch.configs.base import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp="geglu",
    hybrid=HybridConfig(period=3, window=2048, lru_width=2560),
    subquadratic=True,
    tie_embeddings=True,
)
