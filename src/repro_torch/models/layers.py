"""Primitive layers: norms, embeddings, RoPE, activations, dense projections.

PyTorch port of :mod:`repro.models.layers`.  ``init_*`` builds parameter
dicts of tensors, the other functions are pure.  Norm and softmax
statistics accumulate in fp32 whatever the compute dtype.

Initialisers draw from an explicit :class:`torch.Generator`, one tensor at
a time, on ``device`` and directly in the model dtype: at
gemma3-27b's width, drawing the model in fp32 and casting it would need
twice the card's memory.  ``device`` is the generator's own, except on
``meta`` (the dry run's shapes-only init), where PyTorch has no generator
("META device type not an accelerator") and a CPU one stands in: a meta
tensor draws nothing from it.  A generator gives other numbers than
``jax.random`` from the same seed; :func:`repro_torch.interop.params_from_jax`
carries the JAX package's weights across when two runs must agree.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .sharding import rows_whole, rows_whole_grad

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ------------------------------------------------------------------- inits
def init_device(gen: torch.Generator, device=None) -> torch.device:
    """Where an initialiser draws: ``device``, else the generator's."""
    return gen.device if device is None else torch.device(device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device=None) -> torch.Tensor:
    """``[d_in, d_out]`` (the JAX layout: ``x @ w``), N(0, 1/d_in)."""
    w = torch.randn((d_in, d_out), generator=gen,
                    device=init_device(gen, device), dtype=dtype)
    return w.mul_(1.0 / math.sqrt(d_in))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, device=None) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen,
                       device=init_device(gen, device), dtype=dtype)


def init_rmsnorm(d: int, dtype: torch.dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}  # (1 + scale)


# ------------------------------------------------------------------ applies
def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the type JAX promotes the pair to, where PyTorch would
    refuse mixed types: fp32 activations against bf16 weights compute in
    fp32 (a bf16 encoder-decoder fed fp32 frames runs its encoder, and its
    cross-attention's K and V, in fp32, as the JAX package does).  A
    DTensor ``x`` comes with its rows whole (:func:`.sharding.rows_whole`)."""
    x = rows_whole(x)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return rows_whole_grad(x.to(dt) @ w.to(dt))
    return rows_whole_grad(x @ w)


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].float())).to(x.dtype)


def activation(name: str, gate: torch.Tensor,
               up: Optional[torch.Tensor]) -> torch.Tensor:
    if name == "silu":
        return F.silu(gate) * up
    if name == "gelu":
        return F.gelu(gate, approximate="tanh") * up
    if name == "relu2":
        r = F.relu(gate)
        return r * r  # squared-ReLU, ungated (nemotron)
    raise ValueError(name)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (torch.tanh(x.float() / cap) * cap).to(x.dtype)


# --------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over concatenated halves (not interleaved pairs).

    x ``[..., T, H, Dh]``; positions ``[..., T]`` (absolute)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq   # [..., T, half]
    sin = torch.sin(ang)[..., None, :]              # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def learned_positions(table: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    # extend-by-wraparound beyond the published table
    return table[positions % table.shape[0]]
