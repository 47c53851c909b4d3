"""gemma3-27b [dense] — hf:google/gemma-3-1b-pt family (unverified).

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144; 5 local
(sliding-window 1024) : 1 global interleave; 128k context.

PyTorch port: a copy of :mod:`repro.configs.gemma3_27b`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    source="hf:google/gemma-3-1b-pt; unverified",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    hidden_act="gelu",
    scale_embeddings=True,
    sliding_window=1024,
    local_per_global=5,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    optimizer_moments="fp32",
)
