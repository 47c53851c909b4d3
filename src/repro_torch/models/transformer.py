"""Model assembly: the decoder-only LM of the dense, MoE, SSM and hybrid
architectures, and the encoder-decoder (audio).

PyTorch port of :mod:`repro.models.transformer`.  The JAX package runs its
layer stack as ``jax.lax.scan`` over *repeating groups* (one group = the
architecture's layer pattern, e.g. 6 for gemma3's 5 local : 1 global) with
parameters stacked ``[n_groups, ...]``, and the layers that do not fill a
group ("tail") unrolled.  PyTorch runs eagerly, so here the parameters are
one dict per layer (``params["layers"]``, in layer order) and the stack is
a Python loop.  The decode cache keeps the JAX layout — ``"groups"``: one
dict per group position with leaves ``[n_groups, B, ...]``, ``"tail"``: one
dict per tail layer with leaves ``[B, ...]`` — so the engine's splice rule
and the caches of the two packages compare directly; layer ``i`` of the
groups reads position ``i % group_len`` at index ``i // group_len``.

Modes: ``train`` (logits), ``prefill`` (logits + cache), ``decode`` (one
token + cache update, in place), for attention and Mamba mixers alike; a
hybrid's groups mix the two, and its cache holds each position's kind.
``forward`` returns the MoE layers' summed load-balance loss beside its
output, as the JAX ``forward`` does (0 for a model without MoE layers).
In ``train`` mode under autograd, ``cfg.remat`` wraps each layer in
``torch.utils.checkpoint`` (non-reentrant), where the JAX package wraps
each scanned group or tail layer in ``jax.checkpoint``: the values are
the same, only what is kept for the backward differs (a layer's input;
the rest is recomputed, the MoE router too, which on one device with the
same input selects the same experts).
The encoder-decoder (``whisper-tiny``) runs its encoder unrolled over
precomputed frames (the audio frontend is a stub in both packages), with
non-causal self-attention and no remat, as the JAX package does; each
decoder layer adds a cross-attention step against the encoder's output
when there is one (from ``encoder_frames``, else from the cache's
``enc_out``), and skips it otherwise.  Under remat the encoder's output
is an argument of each recomputed layer, so its gradient reaches the
encoder.  The vision frontend's ``patch_embeds`` (precomputed, as in the JAX
package) are spliced over the leading positions after the embedding
scale and before the learned positions, as the JAX ``forward`` does.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import attention_forward, init_attention, init_cache
from .layers import (dense_init, dtype_of, embed_init, init_device,
                     init_rmsnorm, learned_positions, mm, rmsnorm, softcap)
from .mamba import init_mamba, init_mamba_cache, mamba_forward
from .mlp import dense_ffn, init_dense_ffn, init_moe_ffn, moe_ffn
from .sharding import constrain


def layer_kinds(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """(mixer, ffn) of every (decoder) layer, in order."""
    return [cfg.layer_kind(i) for i in range(cfg.n_layers)]


def _plan(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, n_tail, group_len) of the JAX package's layer plan."""
    if not cfg.scan_layers:
        return 0, cfg.n_layers, cfg.n_layers
    g = cfg.group_len
    n_groups = cfg.n_layers // g
    return n_groups, cfg.n_layers - n_groups * g, g


# ---------------------------------------------------------------------- init
def init_layer(gen: torch.Generator, cfg: ModelConfig, mixer: str, ffn: str,
               dtype: torch.dtype, dev=None, cross: bool = False) -> Dict:
    dev = init_device(gen, dev)
    p: Dict[str, Any] = {"norm1": init_rmsnorm(cfg.d_model, dtype, dev)}
    if mixer == "mamba":
        p["mamba"] = init_mamba(gen, cfg, dtype, dev)
    else:
        p["attn"] = init_attention(gen, cfg, dtype, dev)
    if cross:
        p["norm_cross"] = init_rmsnorm(cfg.d_model, dtype, dev)
        p["cross"] = init_attention(gen, cfg, dtype, dev)
    if ffn != "none":
        p["norm2"] = init_rmsnorm(cfg.d_model, dtype, dev)
        p["ffn"] = (init_moe_ffn(gen, cfg, dtype, dev) if ffn == "moe"
                    else init_dense_ffn(gen, cfg, dtype, dev))
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, dev=None) -> Dict:
    """Random parameters on ``dev`` (the generator's device unless given),
    drawn tensor by tensor from ``gen`` (see :mod:`.layers` for
    ``meta``)."""
    dtype = dtype_of(cfg)
    dev = init_device(gen, dev)
    kinds = layer_kinds(cfg)
    params: Dict[str, Any] = {
        "embed": {"tok": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                                    dev)},
        "final_norm": init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if cfg.pos_embedding == "learned":
        length = cfg.decoder_positions or 2048
        params["embed"]["pos"] = embed_init(gen, length, cfg.d_model, dtype,
                                            dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dtype,
                                       dev)
    params["layers"] = [init_layer(gen, cfg, mixer, ffn, dtype, dev,
                                   cross=cfg.is_encoder_decoder)
                        for mixer, ffn in kinds]
    if cfg.is_encoder_decoder:
        params["encoder"] = {
            "layers": [init_layer(gen, cfg, "attn", "dense", dtype, dev)
                       for _ in range(cfg.n_encoder_layers)],
            "pos": embed_init(gen, cfg.encoder_positions, cfg.d_model, dtype,
                              dev),
            "final_norm": init_rmsnorm(cfg.d_model, dtype, dev),
        }
    return params


# --------------------------------------------------------------------- cache
def init_decode_cache(cfg: ModelConfig, batch: int, length: int,
                      device) -> Dict:
    """Whole-model zeroed cache, in the JAX package's groups/tail layout."""
    dtype = dtype_of(cfg)
    kinds = layer_kinds(cfg)
    n_groups, n_tail, g = _plan(cfg)

    def one(mixer: str, lead: Tuple[int, ...] = ()) -> Dict:
        if mixer == "mamba":
            c = init_mamba_cache(cfg, batch, dtype, device)
        else:
            c = init_cache(cfg, batch, length, window=(mixer == "attn_local"),
                           dtype=dtype, device=device)
        if not lead:
            return c
        return {name: t.new_zeros(lead + tuple(t.shape))
                for name, t in c.items()}

    cache: Dict[str, Any] = {}
    if n_groups:
        cache["groups"] = [one(kinds[j][0], (n_groups,)) for j in range(g)]
    cache["tail"] = [one(kinds[n_groups * g + i][0]) for i in range(n_tail)]
    if cfg.is_encoder_decoder:
        cache["enc_out"] = torch.zeros(
            (batch, cfg.encoder_positions, cfg.d_model), dtype=dtype,
            device=device)
    return cache


def layer_cache(cache: Dict, cfg: ModelConfig, i: int) -> Dict:
    """Layer ``i``'s cache: views into ``cache``, so writes go through."""
    n_groups, _, g = _plan(cfg)
    if i < n_groups * g:
        grp, j = divmod(i, g)
        return {name: t[grp] for name, t in cache["groups"][j].items()}
    return cache["tail"][i - n_groups * g]


def _assemble_cache(cfg: ModelConfig, per_layer: List[Dict]) -> Dict:
    """Per-layer prefill caches stacked into the groups/tail layout."""
    n_groups, _, g = _plan(cfg)
    cache: Dict[str, Any] = {}
    if n_groups:
        cache["groups"] = [
            {name: torch.stack([per_layer[grp * g + j][name]
                                for grp in range(n_groups)])
             for name in per_layer[j]}
            for j in range(g)]
    cache["tail"] = per_layer[n_groups * g:]
    return cache


# ------------------------------------------------------------------- forward
def apply_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor, mixer: str,
                ffn: str, *, positions, mode, cache, cache_len,
                enc_out: Optional[torch.Tensor] = None,
                max_cache_len: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict],
                           Optional[torch.Tensor]]:
    """(output, new cache, the MoE load-balance loss or None).  ``mode``
    ``"encode"`` is the encoder's (non-causal, no cache)."""
    aux = None
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if mixer == "mamba":
        att, new_cache = mamba_forward(p["mamba"], cfg, h, mode=mode,
                                       cache=cache)
    else:
        window = cfg.sliding_window if mixer == "attn_local" else None
        causal = not (cfg.is_encoder_decoder and mode == "encode")
        att, new_cache = attention_forward(
            p["attn"], cfg, h, positions=positions, mode=mode, causal=causal,
            window=window, cache=cache, cache_len=cache_len,
            max_cache_len=max_cache_len)
    x = x + att
    if "cross" in p and enc_out is not None:
        hc = rmsnorm(p["norm_cross"], x, cfg.norm_eps)
        catt, _ = attention_forward(
            p["cross"], cfg, hc, positions=positions, mode="train",
            kv_override=(enc_out, enc_out))
        x = x + catt
    if ffn != "none":
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if ffn == "moe":
            y, aux = moe_ffn(p["ffn"], cfg, h2)
        else:
            y = dense_ffn(p["ffn"], cfg, h2)
        x = x + y
    return x, new_cache, aux


def _train_layer(p: Dict, cfg: ModelConfig, x: torch.Tensor, mixer: str,
                 ffn: str, positions: torch.Tensor,
                 enc_out: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer in ``train`` mode (the function remat recomputes)."""
    x, _, aux = apply_layer(p, cfg, x, mixer, ffn, positions=positions,
                            mode="train", cache=None, cache_len=None,
                            enc_out=enc_out)
    return x, aux


def encoder_forward(params: Dict, cfg: ModelConfig,
                    frames: torch.Tensor) -> torch.Tensor:
    """The encoder over precomputed (stub-frontend) frame embeddings
    ``[B, S, d_model]``: ``[B, S, d_model]``, in the frames' type promoted
    with the weights' (fp32 frames run a bf16 encoder in fp32, as in
    JAX)."""
    enc = params["encoder"]
    S = frames.shape[1]
    x = frames + enc["pos"][None, :S, :]
    pos = torch.arange(S, device=frames.device)[None].expand(
        frames.shape[:2])
    for lp in enc["layers"]:
        x, _, _ = apply_layer(lp, cfg, x, "attn", "dense", positions=pos,
                              mode="encode", cache=None, cache_len=None)
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def embed_tokens(params: Dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """``[B, T, d_model]`` token embeddings in the model dtype."""
    dtype = dtype_of(cfg)
    B, T = tokens.shape
    table = params["embed"]["tok"]
    x = torch.index_select(table, 0, tokens.reshape(-1)).reshape(
        B, T, -1).to(dtype)
    if cfg.scale_embeddings:
        # the scale is rounded to the model dtype first, as JAX does
        # (in bfloat16, sqrt(5376) = 73.32 becomes 73.5)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def forward(
    params: Dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                    # [B, T]
    *,
    mode: str = "train",                     # train | prefill | decode
    cache: Optional[Dict] = None,
    cache_len: Optional[torch.Tensor] = None,  # int32[B]
    patch_embeds: Optional[torch.Tensor] = None,  # [B, P, d_model]
    encoder_frames: Optional[torch.Tensor] = None,  # [B, S_enc, d_model]
    return_hidden: bool = False,
    max_cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """Returns (logits | hidden, new_cache, aux): ``aux`` is the fp32 sum
    of the MoE layers' load-balance losses.  Decode updates ``cache`` in
    place and returns it.  For a vision frontend, ``patch_embeds`` replace
    the first ``P`` (scaled) token embeddings; an encoder-decoder encodes
    ``encoder_frames`` (else reads the cache's ``enc_out``), and a
    prefill's cache holds the encoder's output."""
    dtype = dtype_of(cfg)
    B, T = tokens.shape
    kinds = layer_kinds(cfg)

    x = embed_tokens(params, cfg, tokens)
    if patch_embeds is not None and cfg.frontend == "vision":
        n_patches = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(dtype), x[:, n_patches:, :]], dim=1)
    if mode == "decode":
        if cache is None or cache_len is None:
            raise ValueError("decode mode needs a cache and cache_len")
        positions = cache_len[:, None]                      # [B, 1]
    else:
        positions = torch.arange(T, device=tokens.device)[None].expand(B, T)
    if cfg.pos_embedding == "learned":
        x = x + learned_positions(params["embed"]["pos"], positions).to(dtype)
    x = constrain(x, "batch", "seq", "embed")

    enc_out = None
    if cfg.is_encoder_decoder:
        if encoder_frames is not None:
            enc_out = encoder_forward(params, cfg, encoder_frames)
        elif cache is not None:
            enc_out = cache["enc_out"]

    new_caches: List[Dict] = []
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    remat = mode == "train" and cfg.remat and torch.is_grad_enabled()
    for i, (mixer, ffn) in enumerate(kinds):
        if remat:
            x, aux = checkpoint(_train_layer, params["layers"][i], cfg, x,
                                mixer, ffn, positions, enc_out,
                                use_reentrant=False)
        else:
            lc = layer_cache(cache, cfg, i) if cache is not None else None
            x, nc, aux = apply_layer(
                params["layers"][i], cfg, x, mixer, ffn, positions=positions,
                mode=mode, cache=lc, cache_len=cache_len, enc_out=enc_out,
                max_cache_len=max_cache_len)
            new_caches.append(nc if nc is not None else lc)
        if aux is not None:
            aux_total = aux_total + aux

    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_hidden:
        out = x
    else:
        out = constrain(lm_logits(params, cfg, x), "batch", "seq", "vocab")

    new_cache = None
    if mode == "decode":
        new_cache = cache
    elif mode == "prefill":
        new_cache = _assemble_cache(cfg, new_caches)
        if enc_out is not None:
            new_cache["enc_out"] = enc_out
    return out, new_cache, aux_total


def lm_logits(params: Dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits of hidden states ``h`` (tied or untied head)."""
    if cfg.tie_embeddings:
        logits = mm(h, params["embed"]["tok"].t())
    else:
        logits = mm(h, params["lm_head"])
    return softcap(logits, cfg.logit_softcap)
