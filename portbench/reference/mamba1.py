"""Plain fp32 reference of a Mamba-1 layer: RMS norm, the input projection
to x and the gate z, a depthwise causal conv over x (zero history), SiLU,
the projections to the step size, B and C, softplus, the selective scan,
the gate SiLU(z), the output projection and the residual.  The layout the
program keeps its weights in; it imports nothing of the program."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import mm, rmsnorm, selective_scan


def layer(w: Dict, x: torch.Tensor, spec, prec: str = "fp32",
          checkpoint: bool = False, scan_channels=None) -> torch.Tensor:
    B, T, _ = x.shape
    m = w["mamba"]
    di, n, r, kw = spec.d_inner, spec.ssm_state, spec.dt_rank, spec.ssm_conv
    y = rmsnorm(x, w["norm1"]["scale"], spec.norm_eps)
    xz = mm(y, m["in_proj"], prec)
    xi, z = xz[..., :di], xz[..., di:]
    xp = F.pad(xi, (0, 0, kw - 1, 0))
    conv = sum(xp[:, i:i + T, :] * m["conv_w"][i] for i in range(kw)) + m["conv_b"]
    u = F.silu(conv)
    bcd = mm(u, m["x_proj"], prec)
    dt_in, Bm, Cm = bcd[..., :r], bcd[..., r:r + n], bcd[..., r + n:]
    delta = F.softplus(mm(dt_in, m["dt_w"], prec) + m["dt_b"])
    A = -torch.exp(m["A_log"])
    s = selective_scan(u, delta, A, Bm, Cm, m["Dp"], channels=scan_channels,
                       checkpoint=checkpoint)
    return x + mm(s * F.silu(z), m["out_proj"], prec)
