"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (hf-verified).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2;
Mamba:attention 7:1 interleave (1 attn layer per 8, offset 4), MoE every
other layer.  398B total params; factored/bf16 optimizer state (DESIGN §5).

PyTorch port: a copy of :mod:`repro.configs.jamba_1_5_large_398b`; everything below
this docstring is unchanged.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887; hf",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    hidden_act="silu",
    n_experts=16,
    experts_per_token=2,
    moe_period=2,
    moe_offset=1,
    attn_period=8,
    attn_offset=4,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    pos_embedding="none",   # jamba uses no positional encoding
    tie_embeddings=False,
    capacity_factor=1.0,
    optimizer_moments="factored",
    kv_cache_dtype="int8",
)
