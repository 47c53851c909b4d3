"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified).

64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072, MoE 8e top-2.
Memory policy: factored second moment + bf16 first moment (314B params on
256 chips leaves no room for 12 B/param optimizer state; DESIGN.md §5).

PyTorch port: a copy of :mod:`repro.configs.grok_1_314b`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    source="hf:xai-org/grok-1; unverified",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    hidden_act="gelu",
    n_experts=8,
    experts_per_token=2,
    moe_period=1,
    logit_softcap=30.0,
    tie_embeddings=True,
    capacity_factor=1.0,
    optimizer_moments="factored",
    kv_cache_dtype="int8",
)
