"""qwen2-moe-a2.7b — 60 routed top-4 + 4 shared experts [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16H MHA (kv=16), expert FFN 1408, shared-expert FFN
5632 (4 shared experts fused), vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared=4, d_shared=5632),
)
