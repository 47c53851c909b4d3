"""Attention blocks: GQA/MHA, causal, sliding-window, cross, KV caching.

PyTorch port of :mod:`repro.models.attention`.  Three execution modes share
one parameter set:

* ``train`` / ``prefill``: full-sequence attention through
  :func:`~repro_torch.kernels.flash_attention.flash_attention` (the CUDA
  kernel on the card, its plain version on the CPU);
* ``decode``: one token against a cache through
  :func:`~repro_torch.kernels.decode_attention.decode_attention` — a
  contiguous buffer for global layers, a **ring buffer of size window** for
  sliding-window layers (keys are RoPE-rotated before caching, so slot
  order is irrelevant to the softmax);
* optional int8-quantised cache (per-token per-head scales).

The JAX package calls its Pallas kernels only when asked (``use_pallas``);
the port has no such switch.  Decode writes the new token's K and V into
the cache **in place** (JAX returns an updated copy); the returned cache is
the same dict.  Cross-attention (``kv_override``) projects K and V from
the encoder's output, with no rope, no mask and no cache, in every mode:
in decode it is one query a row against every encoder position, through
the prefill kernel, as the JAX package calls it (``mode="train"``).
Products follow JAX's type promotion (:func:`~.layers.mm`): an fp32
encoder output against bf16 weights gives fp32 K and V, which reach the
kernel in q's type, as the jnp reference casts them.

Under sharding rules with DTensor parameters and activations, q and the
block's output are constrained as in the JAX package, the kernels take
each rank's shard (:func:`~.sharding.attention_map`), and decode writes
the new token into each rank's own cache shard (:func:`_write_slot`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Replicate, Shard

from ..configs.base import ModelConfig
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from .layers import dense_init, mm, rope
from .sharding import constrain, is_dtensor, merge_last, roll, split_last


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, device=None) -> Dict:
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, h * dh, dtype, device),
        "wk": dense_init(gen, d, hk * dh, dtype, device),
        "wv": dense_init(gen, d, hk * dh, dtype, device),
        "wo": dense_init(gen, h * dh, d, dtype, device),
    }


# ----------------------------------------------------------- cache handling
def quantize_kv(x: torch.Tensor, dtype: str
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """[B, Hkv, S, Dh] -> (stored, scale) with per-(token, head) scales."""
    if dtype != "int8":
        return x, None
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: Optional[torch.Tensor],
                  dtype: torch.dtype) -> torch.Tensor:
    if scale is None:
        return q
    return (q.float() * scale).to(dtype)


def init_cache(cfg: ModelConfig, batch: int, length: int, *, window: bool,
               dtype: torch.dtype, device) -> Dict:
    """Zeroed cache for one attention layer."""
    size = min(length, cfg.sliding_window) if (window and cfg.sliding_window) else length
    hk, dh = cfg.n_kv_heads, cfg.head_dim
    store_dtype = torch.int8 if cfg.kv_cache_dtype == "int8" else dtype
    c = {
        "k": torch.zeros((batch, hk, size, dh), dtype=store_dtype, device=device),
        "v": torch.zeros((batch, hk, size, dh), dtype=store_dtype, device=device),
    }
    if cfg.kv_cache_dtype == "int8":
        c["k_scale"] = torch.zeros((batch, hk, size, 1), dtype=torch.float32,
                                   device=device)
        c["v_scale"] = torch.zeros((batch, hk, size, 1), dtype=torch.float32,
                                   device=device)
    return c


def _write_slot(buf, val: torch.Tensor, slot: torch.Tensor) -> None:
    """``buf[b, :, slot[b], :] = val[b]`` for a DTensor cache ``[B, Hkv,
    S, Dh]``, in place on each rank's shard: ``val`` ``[B, Hkv, Dh]`` and
    ``slot`` ``[B]`` are placed as the cache's batch and head dims; where
    the slots are sharded, a rank whose range misses a row's slot writes
    that row's own value back."""
    mesh = buf.device_mesh
    bl = buf.to_local()
    v_pl = tuple(p if p in (Shard(0), Shard(1)) else
                 Shard(2) if p == Shard(3) else Replicate()
                 for p in buf.placements)
    s_pl = tuple(p if p == Shard(0) else Replicate() for p in buf.placements)
    vl = val.redistribute(mesh, v_pl).to_local()
    sl = slot.redistribute(mesh, s_pl).to_local()
    lo = 0
    for j, p in enumerate(buf.placements):
        if p == Shard(2):
            lo = lo * mesh.size(j) + mesh.get_local_rank(j)
    lo *= bl.shape[2]
    loc = sl - lo
    inside = (loc >= 0) & (loc < bl.shape[2])
    loc = torch.clamp(loc, 0, bl.shape[2] - 1)
    rows = torch.arange(bl.shape[0], device=bl.device)
    bl[rows, :, loc, :] = torch.where(inside[:, None, None], vl,
                                      bl[rows, :, loc, :])


def _ring(x: torch.Tensor, T: int, keep: int, size: int,
          rolled: bool) -> torch.Tensor:
    """The last ``keep`` of T positions padded to ``size`` slots; rolled so
    that absolute position p lives at slot ``p % size``."""
    xc = x[:, :, T - keep:, :]
    if size > keep:
        xc = F.pad(xc, (0, 0, 0, size - keep))
    if rolled:
        xc = roll(xc, (T - keep) % size, 2)
    return xc.contiguous()


# ------------------------------------------------------------------ forward
def attention_forward(
    p: Dict,
    cfg: ModelConfig,
    x: torch.Tensor,                          # [B, T, D]
    *,
    positions: torch.Tensor,                  # [B, T] absolute positions
    mode: str,                                # train | prefill | decode
    causal: bool = True,
    window: Optional[int] = None,
    cache: Optional[Dict] = None,
    cache_len: Optional[torch.Tensor] = None,  # int32[B]
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    max_cache_len: Optional[int] = None,      # prefill: cache capacity
) -> Tuple[torch.Tensor, Optional[Dict]]:
    B, T, D = x.shape
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype

    q = split_last(mm(x, p["wq"]), h, dh)
    if kv_override is None:
        k = split_last(mm(x, p["wk"]), hk, dh)
        v = split_last(mm(x, p["wv"]), hk, dh)
        if cfg.pos_embedding == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
    else:
        enc = kv_override[0]  # [B, S_enc, D]
        k = split_last(mm(enc, p["wk"]), hk, dh)
        v = split_last(mm(enc, p["wv"]), hk, dh)
        causal, window = False, None
    q = q.transpose(1, 2)  # [B, H, T, Dh]
    q = constrain(q, "batch", "heads", None, None)

    new_cache = None
    if mode == "decode" and kv_override is None:
        if cache is None or cache_len is None or T != 1:
            raise ValueError(
                f"decode mode needs a cache, cache_len, and T == 1 "
                f"(got cache={cache is not None}, "
                f"cache_len={cache_len is not None}, T={T})")
        k1 = k.transpose(1, 2)  # [B, Hkv, 1, Dh]
        v1 = v.transpose(1, 2)
        size = cache["k"].shape[2]
        # ring-buffer slot: absolute position p lives at slot p % size
        # (for global layers size == max length, so slot == cache_len)
        slot = (cache_len % size).long()
        rows = torch.arange(B, device=x.device)
        kq, ks = quantize_kv(k1, cfg.kv_cache_dtype)
        vq, vs = quantize_kv(v1, cfg.kv_cache_dtype)
        # in place: row b's slot of every kv head
        writes = [("k", kq), ("v", vq)]
        if cfg.kv_cache_dtype == "int8":
            writes += [("k_scale", ks), ("v_scale", vs)]
        for name, val in writes:
            if is_dtensor(cache[name]):
                _write_slot(cache[name], val[:, :, 0, :], slot)
            else:
                cache[name][rows, :, slot, :] = val[:, :, 0, :]
        new_cache = cache

        k_full = dequantize_kv(cache["k"], cache.get("k_scale"), dt)
        v_full = dequantize_kv(cache["v"], cache.get("v_scale"), dt)
        valid = torch.clamp(cache_len + 1, max=size).to(torch.int32)  # ring: whole buffer once wrapped
        out = decode_attention(
            q[:, :, 0, :].contiguous(), k_full, v_full, valid,
            scale=dh ** -0.5)  # [B, H, Dh]
        out = out[:, :, None, :]
    else:
        # [B, Hkv, S, Dh]; cross-attention's fp32 K / V in q's type
        k = k.transpose(1, 2).to(q.dtype).contiguous()
        v = v.transpose(1, 2).to(q.dtype).contiguous()
        out = flash_attention(
            q.contiguous(), k, v, causal=causal, window=window,
            scale=dh ** -0.5)
        if mode == "prefill" and kv_override is None:
            cap = max_cache_len or T
            size = min(cap, window) if window else cap
            keep = min(T, size)
            rolled = keep < T or bool(window and size == window)
            kc = _ring(k, T, keep, size, rolled)
            vc = _ring(v, T, keep, size, rolled)
            kq, ks = quantize_kv(kc, cfg.kv_cache_dtype)
            vq, vs = quantize_kv(vc, cfg.kv_cache_dtype)
            new_cache = {"k": kq, "v": vq}
            if cfg.kv_cache_dtype == "int8":
                new_cache["k_scale"] = ks
                new_cache["v_scale"] = vs

    out = merge_last(out.transpose(1, 2))          # [B, T, h * dh]
    return constrain(mm(out, p["wo"]), "batch", "seq", "embed"), new_cache
