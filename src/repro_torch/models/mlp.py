"""FFN blocks: the gated dense MLP (SwiGLU / GeGLU) and ungated relu².

PyTorch port of the dense half of :mod:`repro.models.mlp`.  The
capacity-routed MoE FFN comes with the MoE slice of the port.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from .layers import activation, dense_init


def init_dense_ffn(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi_gate": dense_init(gen, d, f, dtype)}
    if cfg.hidden_act != "relu2":        # gated activations need the up proj
        p["wi_up"] = dense_init(gen, d, f, dtype)
    p["wo_ff"] = dense_init(gen, f, d, dtype)
    return p


def dense_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    gate = x @ p["wi_gate"]
    up = x @ p["wi_up"] if "wi_up" in p else None
    h = activation(cfg.hidden_act, gate, up)
    return h @ p["wo_ff"]
