"""pixtral-12b [vlm] — hf:mistralai/Pixtral-12B-2409 (unverified).

Decoder backbone (mistral-nemo): 40L d_model=5120 32H (GQA kv=8)
d_ff=14336 vocab=131072, head_dim=128.  The Pixtral-ViT frontend is
STUBBED: ``input_specs()`` provides precomputed patch embeddings that the
backbone splices over the leading positions.

PyTorch port: a copy of :mod:`repro.configs.pixtral_12b`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409; unverified",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    hidden_act="silu",
    rope_theta=1_000_000.0,
    frontend="vision",
    n_patches=256,
    tie_embeddings=False,
    optimizer_moments="fp32",
)
