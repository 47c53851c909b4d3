"""Architecture registry: ``--arch <id>`` resolution + reduced smoke configs.

PyTorch port: a copy of :mod:`repro.configs.registry`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from .base import ModelConfig
from . import (gemma_7b, minitron_4b, gemma3_27b, mistral_large_123b,
               falcon_mamba_7b, granite_moe_1b_a400m, grok_1_314b,
               jamba_1_5_large_398b, whisper_tiny, pixtral_12b)

ARCHS: Dict[str, ModelConfig] = {
    "gemma-7b": gemma_7b.CONFIG,
    "minitron-4b": minitron_4b.CONFIG,
    "gemma3-27b": gemma3_27b.CONFIG,
    "mistral-large-123b": mistral_large_123b.CONFIG,
    "falcon-mamba-7b": falcon_mamba_7b.CONFIG,
    "granite-moe-1b-a400m": granite_moe_1b_a400m.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "jamba-1.5-large-398b": jamba_1_5_large_398b.CONFIG,
    "whisper-tiny": whisper_tiny.CONFIG,
    "pixtral-12b": pixtral_12b.CONFIG,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small widths/depths,
    few experts, tiny vocab — structure (interleaves, MoE, enc-dec,
    frontends) preserved."""
    cfg = get_config(arch)
    kw = dict(
        d_model=64,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=503,
        dtype="float32",
        remat=False,
        n_microbatches=1,
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 2) or 2, head_dim=16)
        # keep MHA archs MHA (gemma-7b kv == heads)
        if cfg.n_kv_heads == cfg.n_heads:
            kw["n_kv_heads"] = 4
    if cfg.n_experts:
        kw.update(n_experts=4, experts_per_token=min(2, cfg.experts_per_token))
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=8, ssm_dt_rank=8)
    # depth: keep ≥ one full repeating group (+ tail, to cover both paths)
    kw["n_layers"] = max(cfg.group_len + (1 if cfg.group_len > 1 else 1), 2)
    if cfg.is_encoder_decoder:
        kw.update(n_encoder_layers=2, encoder_positions=64, decoder_positions=64)
    if cfg.frontend == "vision":
        kw.update(n_patches=8)
    if cfg.sliding_window:
        kw.update(sliding_window=16)
    return dataclasses.replace(cfg, **kw)
