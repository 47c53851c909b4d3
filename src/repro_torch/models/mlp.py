"""FFN blocks: the gated dense MLP (SwiGLU / GeGLU), ungated relu², and the
capacity-routed MoE.

PyTorch port of :mod:`repro.models.mlp`.  The MoE dispatch is the GShard
capacity scheme with the reference's steps: fp32 router, softmax, top-k
with renormalised gates, a per-row stable sort of the token-slots by
expert to rank each slot within its expert (no ``[B, T*K, E]`` one-hot),
and the dispatch and combine as row permutations that are gathers in both
directions (:class:`PermuteRows`).  The expert products are plain batched
matrix products, as in the JAX package, which computes them outside any
Pallas kernel.  Sharding constraints (``constrain``) are the identity
here: the port has no ``sharding.py``.

:func:`route` is looked up at call time, so a caller can wrap it to
observe each layer's routing (which experts, which slots were dropped).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from ..configs.base import ModelConfig
from .layers import activation, dense_init, mm


def init_dense_ffn(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi_gate": dense_init(gen, d, f, dtype)}
    if cfg.hidden_act != "relu2":        # gated activations need the up proj
        p["wi_up"] = dense_init(gen, d, f, dtype)
    p["wo_ff"] = dense_init(gen, f, d, dtype)
    return p


def dense_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    gate = mm(x, p["wi_gate"])
    up = mm(x, p["wi_up"]) if "wi_up" in p else None
    h = activation(cfg.hidden_act, gate, up)
    return mm(h, p["wo_ff"])


# ------------------------------------------------------------------------ MoE
class PermuteRows(torch.autograd.Function):
    """Row permutation that drops out of bounds, batched over B:
    ``out[b, j] = x[b, idx[b, j]]``, with ``idx[b, j] == x.shape[1]``
    giving a zero row.

    Both directions are gathers, as in the JAX ``custom_vjp``: the
    backward gathers the cotangent through the inverse map ``inv``
    (``inv[b, i]`` = where row i landed, or ``idx.shape[1]`` if it was
    dropped), so nothing accumulates and the result does not depend on the
    order of any atomic add."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, idx: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(inv)
        ctx.dtype = x.dtype
        return _gather_rows(x, idx)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        (inv,) = ctx.saved_tensors
        return _gather_rows(ct, inv).to(ctx.dtype), None, None


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[B, N, D]`` rows of ``x`` padded with one zero row, at ``idx``
    (``[B, N]``, values in ``[0, x.shape[1]]``)."""
    B, M, D = x.shape
    xp = torch.cat([x, x.new_zeros((B, 1, D))], dim=1).reshape(B * (M + 1), D)
    offsets = torch.arange(B, device=x.device)[:, None] * (M + 1)
    return torch.index_select(xp, 0, (idx + offsets).reshape(-1)).reshape(
        B, idx.shape[1], D)


def init_moe_ffn(gen: torch.Generator, cfg: ModelConfig,
                 dtype: torch.dtype) -> Dict:
    """The router in fp32 whatever ``dtype``; each expert tensor drawn in
    fp32 and cast to ``dtype`` one expert at a time (at grok-1's width one
    expert tensor is 6.4 GB in fp32, one expert's slice 0.8 GB)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(d_in: int, d_out: int) -> torch.Tensor:
        w = torch.empty((e, d_in, d_out), dtype=dtype, device=gen.device)
        for i in range(e):
            w[i] = torch.randn((d_in, d_out), generator=gen,
                               device=gen.device).mul_(1.0 / math.sqrt(d_in))
        return w

    return {"router": dense_init(gen, d, e, torch.float32),
            "e_gate": experts(d, f),
            "e_up": experts(d, f),
            "e_down": experts(f, d)}


def capacity(cfg: ModelConfig, tokens: int) -> int:
    c = math.ceil(tokens * cfg.experts_per_token / cfg.n_experts
                  * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # sublane-aligned


class Routing(NamedTuple):
    """One MoE layer's routing of ``[B, T]`` tokens to ``E`` experts of
    capacity ``C``: ``sel``/``gate_w`` ``[B, T, K]``, and per token-slot
    (``T*K`` a row) ``keep`` and ``dest`` (its expert slot, ``E*C`` when
    dropped); ``src`` ``[B, E*C]`` is the token-slot that fills each expert
    slot (``T*K`` when empty); ``aux`` the load-balance loss."""
    gate_w: torch.Tensor
    sel: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    src: torch.Tensor
    aux: torch.Tensor


def route(p: Dict, cfg: ModelConfig, x: torch.Tensor, C: int) -> Routing:
    B, T, _ = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    TK = T * K
    dev = x.device

    logits = x.float() @ p["router"]                        # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    # seeded fp32 inputs have no ties; their order within a token would
    # not change any rank (a token takes each expert at most once)
    gate_w, sel = torch.topk(probs, K, dim=-1)              # [B, T, K]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # position in expert without a [B, T*K, E] one-hot: stable-sort the
    # slots by expert, rank within each expert's run, scatter the ranks
    # back (the scatter's indices are a permutation: no two collide)
    sel_flat = sel.reshape(B, TK)                           # slot -> expert
    order = torch.argsort(sel_flat, dim=1, stable=True)
    sorted_e = torch.gather(sel_flat, 1, order)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")   # [B, E]
    ends = torch.searchsorted(sorted_e, experts, side="right")
    slots = torch.arange(TK, device=dev).expand(B, TK)
    rank = slots - torch.gather(starts, 1, sorted_e)
    pos = torch.empty_like(sel_flat).scatter_(1, order, rank)
    keep = pos < C
    dest = torch.where(keep, sel_flat * C + pos, E * C)     # E*C -> dropped

    # load-balance loss (Switch/GShard form); each expert's routed count is
    # the length of its run in the sorted slots (the reference's bincount)
    me = probs.mean(dim=(0, 1))                             # [E]
    ce = (ends - starts).float().mean(0) / TK               # routed fraction
    aux = E * torch.sum(me * ce)

    # invert dest: src[s] = the token-slot that fills expert slot s (TK if
    # empty).  Expert e's kept slots are the first min(count, C) of its
    # run in the sorted order, so slot (e, c) holds order[starts[e] + c]:
    # a gather, where the reference scatters into E*C + 1 slots and cuts
    # the dropped ones' common slot off (under deterministic algorithms
    # a scatter that collides runs each collision in turn)
    c = torch.arange(C, device=dev)
    at = (starts[:, :, None] + c).clamp(max=TK - 1).reshape(B, E * C)
    filled = (c < (ends - starts)[:, :, None]).reshape(B, E * C)
    src = torch.where(filled, torch.gather(order, 1, at), TK)
    return Routing(gate_w, sel, keep, dest, src, aux)


def moe_ffn(p: Dict, cfg: ModelConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, load-balance loss)."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, T)
    r = route(p, cfg, x, C)

    # each token once per chosen expert; its gradient sums the K copies
    x_slots = x[:, :, None, :].expand(B, T, K, D).reshape(B, T * K, D)
    x_disp = PermuteRows.apply(x_slots, r.src, r.dest)      # [B, E*C, D]
    # experts lead: [E, B*C, D] against [E, D, F]
    x_e = x_disp.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)
    gate = torch.bmm(x_e, p["e_gate"])
    up = torch.bmm(x_e, p["e_up"]) if cfg.hidden_act != "relu2" else None
    h = activation(cfg.hidden_act, gate, up)
    y_e = torch.bmm(h, p["e_down"])                         # [E, B*C, D]
    y_flat = y_e.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

    y_slots = PermuteRows.apply(y_flat, r.dest, r.src)      # [B, T*K, D]
    y_slots = torch.where(r.keep[..., None], y_slots, 0)
    y = (y_slots.reshape(B, T, K, D)
         * r.gate_w[..., None].to(x.dtype)).sum(dim=2)
    return y, r.aux
