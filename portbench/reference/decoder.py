"""Plain fp32 reference of a decoder layer: RMS norm, grouped-query
attention with rotary positions (causal), RMS norm, gated SiLU FFN, each
with its residual; the layout the program keeps its weights in (``x @
w``; query head ``h`` reads key head ``h // (Hq / Hkv)``).  It imports
nothing of the program."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .common import mm, rmsnorm, rope

Q_BLOCK = 1024


def attention(q, k, v, q0: int, prec: str) -> torch.Tensor:
    """Causal attention of queries at positions ``q0 + [0, Tq)`` against
    keys ``[0, S)``.  q ``[B, Hkv, G, Tq, D]``, k, v ``[B, Hkv, 1, S, D]``."""
    Tq, S = q.shape[-2], k.shape[-2]
    scale = q.shape[-1] ** -0.5
    s = mm(q, k.transpose(-1, -2), prec) * scale
    qpos = q0 + torch.arange(Tq, device=q.device)
    kpos = torch.arange(S, device=q.device)
    s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return mm(p, v, prec)


def layer(w: Dict, x: torch.Tensor, spec, prec: str = "fp32",
          q_block: int = Q_BLOCK) -> torch.Tensor:
    """One layer on ``x`` ``[B, T, d]`` (positions 0..T-1)."""
    B, T, _ = x.shape
    h, hk, dh = spec.n_heads, spec.n_kv_heads, spec.head_dim
    a = w["attn"]
    pos = torch.arange(T, device=x.device)
    y = rmsnorm(x, w["norm1"]["scale"], spec.norm_eps)
    q = rope(mm(y, a["wq"], prec).view(B, T, h, dh), pos, spec.rope_theta)
    k = rope(mm(y, a["wk"], prec).view(B, T, hk, dh), pos, spec.rope_theta)
    v = mm(y, a["wv"], prec).view(B, T, hk, dh)
    q = q.permute(0, 2, 1, 3).reshape(B, hk, h // hk, T, dh)
    k = k.permute(0, 2, 1, 3)[:, :, None]
    v = v.permute(0, 2, 1, 3)[:, :, None]
    outs = []
    for q0 in range(0, T, q_block):
        q1 = min(T, q0 + q_block)
        outs.append(attention(q[..., q0:q1, :], k[..., :q1, :], v[..., :q1, :],
                              q0, prec))
    o = torch.cat(outs, dim=-2).reshape(B, h, T, dh).permute(0, 2, 1, 3)
    x = x + mm(o.reshape(B, T, h * dh), a["wo"], prec)
    f = w["ffn"]
    y = rmsnorm(x, w["norm2"]["scale"], spec.norm_eps)
    g = F.silu(mm(y, f["wi_gate"], prec)) * mm(y, f["wi_up"], prec)
    return x + mm(g, f["wo_ff"], prec)
