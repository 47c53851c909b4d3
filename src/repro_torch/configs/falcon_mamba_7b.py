"""falcon-mamba-7b [ssm] — arXiv:2410.05355 (unverified); mamba-1 arch.

64L d_model=4096, attention-free, ssm_state=16, d_inner=8192 (expand 2).

PyTorch port: a copy of :mod:`repro.configs.falcon_mamba_7b`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="arXiv:2410.05355; unverified",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    pos_embedding="none",
    tie_embeddings=False,
    optimizer_moments="fp32",
)
