"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407
(unverified).  88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.

int8 KV cache + factored second moment: at 123B the fp32-everything policy
does not fit 16 GB/chip on the single-pod mesh (see DESIGN.md §5).

PyTorch port: a copy of :mod:`repro.configs.mistral_large_123b`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    source="hf:mistralai/Mistral-Large-Instruct-2407; unverified",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    hidden_act="silu",
    tie_embeddings=False,
    rope_theta=1_000_000.0,
    optimizer_moments="factored",
    kv_cache_dtype="int8",
)
