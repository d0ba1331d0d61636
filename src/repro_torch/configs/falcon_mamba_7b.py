"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355].

64L, d_model=4096, vocab=65024, ssm_state=16, expand=2 (d_inner=8192).
Sub-quadratic: long_500k runs (decode state is O(1) in sequence).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=1, n_kv_heads=1, head_dim=1,  # attn-free
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    subquadratic=True,
    tie_embeddings=True,
)
