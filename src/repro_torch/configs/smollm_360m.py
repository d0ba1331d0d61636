"""smollm-360m — llama-architecture small LM [hf:HuggingFaceTB/SmolLM].

32L, d_model=960, 15H (GQA kv=5), d_ff=2560, vocab=49152, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    tie_embeddings=True,
)
