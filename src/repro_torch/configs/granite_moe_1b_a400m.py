"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base
(hf-verified).  24L d_model=1024 16H (GQA kv=8) d_ff=512/expert
vocab=49155, 32 experts top-8.

PyTorch port: a copy of :mod:`repro.configs.granite_moe_1b_a400m`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    hidden_act="silu",
    n_experts=32,
    experts_per_token=8,
    moe_period=1,
    tie_embeddings=True,
    optimizer_moments="fp32",
    # TP-MoE all-gathers the full dispatch buffer per device; 2 microbatches
    # keep the train_4k cell inside 16 GB HBM (EXPERIMENTS.md §Perf)
    n_microbatches=2,
)
