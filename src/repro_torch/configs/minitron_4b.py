"""minitron-4b [dense] — arXiv:2407.14679 (hf-verified); pruned nemotron.

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.  Nemotron family
uses squared-ReLU MLPs (no gating).

PyTorch port: a copy of :mod:`repro.configs.minitron_4b`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679; hf",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    hidden_act="relu2",
    tie_embeddings=True,
    optimizer_moments="fp32",
)
