"""Mamba-1 block (falcon-mamba, jamba mixer layers).

PyTorch port of :mod:`repro.models.mamba`: in_proj → depthwise causal
conv1d → SiLU → selective scan → gate → out_proj.  Prefill runs the scan
through :func:`~repro_torch.kernels.mamba_scan.mamba_scan` (the CUDA
kernel on the card, its plain version on the CPU) and takes the final
state from it; decode runs ``mamba_step`` and writes the conv window and
the state into the engine's cache **in place** (JAX returns an updated
copy).  Both are O(1) in sequence length.  The scan takes the model's
type (fp32 or bf16) as it is, widens it to fp32 inside and writes ``y``
back in it, which is what the JAX package's casts to fp32 around its scan
and back compute; decode keeps those casts.

Prefill keeps the last ``ssm_conv - 1`` inputs as conv history; a prompt
shorter than that keeps only its T rows, and the engine's splice pads the
missing rows with zeros *after* them, so decode reads a zero as the newest
input.  The JAX package does the same, and the port keeps it for parity
(ROADMAP C5).  ``mode="train"`` runs the same scan and returns no cache,
as the JAX block does; under autograd the scan goes through
:class:`~repro_torch.kernels.mamba_scan.MambaScanFunction`, whose backward
is the scan's CUDA backward kernel on the card.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.mamba_scan import mamba_scan, mamba_step
from .layers import dense_init, init_device, mm
from .sharding import constrain, reduced


def init_mamba(gen: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, dev=None) -> Dict:
    """Random parameters on ``dev`` (the generator's device unless given);
    ``A_log`` and ``Dp`` are fp32 whatever the model dtype."""
    d, di, n, r, kw = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                       cfg.ssm_conv)
    dev = init_device(gen, dev)
    A = torch.arange(1, n + 1, dtype=torch.float32, device=dev)[None, :]
    return {
        "in_proj": dense_init(gen, d, 2 * di, dtype, dev),
        "conv_w": torch.randn((kw, di), generator=gen, device=dev,
                              dtype=dtype).mul_(1.0 / math.sqrt(kw)),
        "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
        "x_proj": dense_init(gen, di, r + 2 * n, dtype, dev),
        "dt_w": dense_init(gen, r, di, dtype, dev),
        "dt_b": torch.full((di,), -4.6, dtype=dtype, device=dev),  # softplus^-1(0.01)
        "A_log": torch.log(A.repeat(di, 1)),                       # fp32
        "Dp": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype, dev),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict:
    """Zeroed cache for one Mamba layer: conv history and fp32 state."""
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  x ``[B, T, Di]``, w ``[K, Di]``; the taps
    are summed in the JAX package's order."""
    K = w.shape[0]
    T = x.shape[1]
    pad = history if history is not None else x.new_zeros(
        (x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)                   # [B, T+K-1, Di]
    out = sum(xp[:, i:i + T, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def _ssm_inputs(p: Dict, cfg: ModelConfig, u: torch.Tensor):
    """(delta, Bm, Cm, A) of the post-conv activations ``u``."""
    r, n = cfg.dt_rank, cfg.ssm_state
    # the contraction runs over the channels "ff" shards: its partial sums
    # are reduced before the bias, sharded over "ff", is added to them
    bcd = reduced(mm(u, p["x_proj"]))                 # [B, T, r+2n]
    dt_in, Bm, Cm = torch.split(bcd, [r, n, n], dim=-1)
    delta = F.softplus(mm(dt_in, p["dt_w"]) + p["dt_b"])
    A = -torch.exp(p["A_log"])
    return delta, Bm, Cm, A


def mamba_forward(
    p: Dict, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
    cache: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (out ``[B, T, d_model]``, new cache): a fresh cache for
    prefill, ``cache`` itself (updated in place) for decode, None for
    train."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mamba mode {mode!r}")
    B, T, _ = x.shape
    dt = x.dtype

    xz = mm(x, p["in_proj"])                          # [B, T, 2Di]
    xz = constrain(xz, "batch", "seq", "ff")
    xi, z = torch.chunk(xz, 2, dim=-1)
    conv_w, conv_b = p["conv_w"].to(dt), p["conv_b"].to(dt)

    if mode == "decode":
        if cache is None or T != 1:
            raise ValueError(
                f"decode mode needs a conv cache and T == 1 "
                f"(got cache={cache is not None}, T={T})")
        hist = cache["conv"].to(dt)
        conv_out = _causal_conv(xi, conv_w, conv_b, hist)
        new_conv = torch.cat([hist, xi], dim=1)[:, 1:, :]
        u = F.silu(conv_out)                          # [B, 1, Di]
        delta, Bm, Cm, A = _ssm_inputs(p, cfg, u)
        y, h_new = mamba_step(
            u[:, 0].float(), delta[:, 0].float(), A, Bm[:, 0].float(),
            Cm[:, 0].float(), p["Dp"], cache["h"])
        y = y[:, None, :].to(dt)
        # in place: the engine's cache holds this layer's window and state
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_new)
        new_cache = cache
    else:
        conv_out = _causal_conv(xi, conv_w, conv_b)
        u = F.silu(conv_out)
        delta, Bm, Cm, A = _ssm_inputs(p, cfg, u)
        # the scan reads the model's type and writes y in it (Bm and Cm are
        # views of one projection: copied, T x N values each)
        y, hT = mamba_scan(u, delta, A, Bm.contiguous(), Cm.contiguous(),
                           p["Dp"])
        new_cache = None
        if mode == "prefill":
            kw = cfg.ssm_conv
            # a copy: a view of xi would keep the whole [B, T, 2Di] xz alive
            new_cache = {"conv": xi[:, -(kw - 1):, :].to(dt).contiguous(),
                         "h": hT}

    y = y * F.silu(z)
    return constrain(mm(y, p["out_proj"]), "batch", "seq", "embed"), new_cache
