"""minitron-8b — pruned Nemotron-4 [arXiv:2407.14679].

32L, d_model=4096, 32H (GQA kv=8), d_ff=16384, vocab=256000,
squared-ReLU MLP, partial rotary (Nemotron lineage).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    mlp="relu2",
    rotary_pct=0.5,
)
