"""FFN blocks: the gated dense MLP (SwiGLU / GeGLU), ungated relu², and the
capacity-routed MoE.

PyTorch port of :mod:`repro.models.mlp`.  The MoE dispatch is the GShard
capacity scheme with the reference's steps: fp32 router, softmax, top-k
with renormalised gates, a per-row stable sort of the token-slots by
expert to rank each slot within its expert (no ``[B, T*K, E]`` one-hot),
and the dispatch and combine as row permutations that are gathers in both
directions (:class:`PermuteRows`).  The expert products are plain batched
matrix products, as in the JAX package, which computes them outside any
Pallas kernel.  The JAX package's seven sharding constraints stand at
their counterparts (the experts' products lead with the experts here, so
the gate's is ``("experts", None, "ff")`` over ``[E, B*C, F]``).  Under
sharding rules the routing's sort, top-k, searchsorted, gathers and
scatters and the row permutations have no DTensor strategy: they run on
each rank's rows through ``local_map`` (:func:`_route_sharded`,
:func:`permute_rows`), the load-balance loss's two means as averages
over the ranks that share the batch.

:func:`route` is looked up at call time, so a caller can wrap it to
observe each layer's routing (which experts, which slots were dropped).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from .layers import activation, dense_init, init_device, mm
from .sharding import (constrain, current_rules, is_dtensor, local_kernel,
                       logical_spec, placements, reshape)


def init_dense_ffn(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, device=None) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    p = {"wi_gate": dense_init(gen, d, f, dtype, device)}
    if cfg.hidden_act != "relu2":        # gated activations need the up proj
        p["wi_up"] = dense_init(gen, d, f, dtype, device)
    p["wo_ff"] = dense_init(gen, f, d, dtype, device)
    return p


def dense_ffn(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    gate = mm(x, p["wi_gate"])
    gate = constrain(gate, "batch", "seq", "ff")
    up = mm(x, p["wi_up"]) if "wi_up" in p else None
    h = activation(cfg.hidden_act, gate, up)
    return constrain(mm(h, p["wo_ff"]), "batch", "seq", "embed")


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


def permute_rows(x: torch.Tensor, idx: torch.Tensor,
                 inv: torch.Tensor) -> torch.Tensor:
    """:class:`PermuteRows` of ``x``; of each rank's rows for DTensors."""
    if is_dtensor(x):
        B, _, D = x.shape
        return local_kernel(
            PermuteRows.apply, (x, idx, inv),
            (("batch", None, None), ("batch", None), ("batch", None)),
            (((B, idx.shape[1], D), ("batch", None, None)),), split_by=0)
    return PermuteRows.apply(x, idx, inv)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``[B, N, D]`` rows of ``x`` padded with one zero row, at ``idx``
    (``[B, N]``, values in ``[0, x.shape[1]]``)."""
    B, M, D = x.shape
    xp = torch.cat([x, x.new_zeros((B, 1, D))], dim=1).reshape(B * (M + 1), D)
    offsets = torch.arange(B, device=x.device)[:, None] * (M + 1)
    return torch.index_select(xp, 0, (idx + offsets).reshape(-1)).reshape(
        B, idx.shape[1], D)


def init_moe_ffn(gen: torch.Generator, cfg: ModelConfig,
                 dtype: torch.dtype, device=None) -> Dict:
    """The router in fp32 whatever ``dtype``; each expert tensor drawn in
    fp32 and cast to ``dtype`` one expert at a time (at grok-1's width one
    expert tensor is 6.4 GB in fp32, one expert's slice 0.8 GB)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    device = init_device(gen, device)

    def experts(d_in: int, d_out: int) -> torch.Tensor:
        w = torch.empty((e, d_in, d_out), dtype=dtype, device=device)
        for i in range(e):
            w[i] = torch.randn((d_in, d_out), generator=gen,
                               device=device).mul_(1.0 / math.sqrt(d_in))
        return w

    return {"router": dense_init(gen, d, e, torch.float32, device),
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
    parts = (_route_sharded if is_dtensor(x) else _route_rows)(p, cfg, x, C)
    gate_w, sel, keep, dest, src, me, ce = parts
    aux = cfg.n_experts * torch.sum(me * ce)
    return Routing(gate_w, sel, keep, dest, src, aux)


def _route_sharded(p: Dict, cfg: ModelConfig, x: torch.Tensor, C: int):
    """:func:`_route_rows` on each rank's rows (DTensors): the router is
    gathered whole, its gradient a partial sum over the batch's ranks;
    ``me`` and ``ce`` are the mean over the ranks' own means, each rank's
    a row of a ``[ranks, E]`` DTensor (so autograd divides as the mean
    does)."""
    def local(router, xl):
        *fields, me, ce = _route_rows({"router": router}, cfg, xl, C)
        return (*fields, me[None], ce[None])

    mesh = x.device_mesh
    rules = current_rules()
    spec = (logical_spec(x.shape, ("batch", None, None), rules)
            if rules is not None else ())
    x_pl = placements(spec, mesh)
    rows = tuple(Shard(0) if p == Shard(0) else Replicate() for p in x_pl)
    rep = tuple(Replicate() for _ in x_pl)
    grad = tuple(Partial() if p == Shard(0) else Replicate() for p in x_pl)
    *fields, me, ce = local_map(
        local, out_placements=(rows,) * 7,
        in_placements=(rep, rows), in_grad_placements=(grad, rows),
        device_mesh=mesh, redistribute_inputs=True)(p["router"], x)
    return (*fields, me.mean(0), ce.mean(0))


def _route_rows(p: Dict, cfg: ModelConfig, x: torch.Tensor, C: int):
    """Routing fields of each row, and the two means of the load-balance
    loss: ``(gate_w, sel, keep, dest, src, me, ce)``."""
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
    return gate_w, sel, keep, dest, src, me, ce


def moe_ffn(p: Dict, cfg: ModelConfig,
            x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, load-balance loss)."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    C = capacity(cfg, T)
    r = route(p, cfg, x, C)

    # each token once per chosen expert; its gradient sums the K copies
    x_slots = x[:, :, None, :].expand(B, T, K, D).reshape(B, T * K, D)
    x_slots = constrain(x_slots, "batch", "moe_slots", "embed")
    x_disp = permute_rows(x_slots, r.src, r.dest)           # [B, E*C, D]
    x_disp = constrain(x_disp.reshape(B, E, C, D),
                       "batch", "experts", "moe_cap", "embed")
    # experts lead: [E, B*C, D] against [E, D, F]
    x_e = reshape(x_disp.transpose(0, 1), E, B * C, D)
    gate = torch.bmm(x_e, p["e_gate"])
    gate = constrain(gate, "experts", None, "ff")
    up = torch.bmm(x_e, p["e_up"]) if cfg.hidden_act != "relu2" else None
    h = activation(cfg.hidden_act, gate, up)
    y_e = torch.bmm(h, p["e_down"])                         # [E, B*C, D]
    y_disp = constrain(y_e.reshape(E, B, C, D).transpose(0, 1),
                       "batch", "experts", "moe_cap", "embed")
    y_flat = reshape(y_disp, B, E * C, D)

    y_slots = permute_rows(y_flat, r.dest, r.src)           # [B, T*K, D]
    y_slots = torch.where(r.keep[..., None], y_slots, 0)
    y = (y_slots.reshape(B, T, K, D)
         * r.gate_w[..., None].to(x.dtype)).sum(dim=2)
    return constrain(y, "batch", "seq", "embed"), r.aux
