"""granite-moe-1b-a400m — 32-expert top-8 MoE [hf:ibm-granite/granite-3.0-1b-a400m].

24L, d_model=1024, 16H (GQA kv=8), expert FFN 512, vocab=49155.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_expert=512),
    tie_embeddings=True,
)
