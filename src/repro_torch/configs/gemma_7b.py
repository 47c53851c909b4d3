"""gemma-7b [dense] — arXiv:2403.08295 (hf-verified).

28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000, GeGLU, head_dim=256.

PyTorch port: a copy of :mod:`repro.configs.gemma_7b`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    source="arXiv:2403.08295; hf",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    hidden_act="gelu",
    scale_embeddings=True,
    tie_embeddings=True,
    logit_softcap=None,
    optimizer_moments="fp32",
)
