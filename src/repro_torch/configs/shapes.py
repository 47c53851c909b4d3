"""Assigned input-shape cells and meta-tensor input specs.

PyTorch port of :mod:`repro.configs.shapes`.  Four cells per LM arch
(paper-assignment block):
  train_4k    — seq 4096,  global_batch 256  -> train_step
  prefill_32k — seq 32768, global_batch 32   -> prefill_step
  decode_32k  — seq 32768, global_batch 128  -> decode_step (1 new token)
  long_500k   — seq 524288, global_batch 1   -> decode_step

``long_500k`` requires sub-quadratic attention: it runs for the SSM /
hybrid / sliding-window archs and is skipped for pure full-attention archs
and the enc-dec (DESIGN.md §4 records each skip).

Where the JAX package gives ``jax.ShapeDtypeStruct`` stand-ins, the port
gives tensors on the ``meta`` device: a shape and a type, no storage.
Token ids stay ``int32``, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Tuple

import torch

from .base import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# archs with a sub-quadratic long-context path
LONG_OK_FAMILIES = ("ssm", "hybrid")


def long_context_capable(cfg: ModelConfig) -> bool:
    if cfg.family in LONG_OK_FAMILIES:
        return True
    # sliding-window archs: the windowed layers bound the KV cache; the
    # sparse global layers are linear-in-S at decode (one token per step)
    if cfg.sliding_window and cfg.local_per_global:
        return True
    return False


def cell_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not long_context_capable(cfg):
        return False, "no sub-quadratic attention path (DESIGN.md §4)"
    if cfg.is_encoder_decoder and shape.name == "long_500k":
        return False, "enc-dec: 500k decode undefined (max source 30s audio)"
    return True, ""


def shape_cells(cfg: ModelConfig) -> Iterator[ShapeSpec]:
    for s in SHAPES.values():
        ok, _ = cell_applicable(cfg, s)
        if ok:
            yield s


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for the *batch* of one step (no storage).
    Caches and state come from ``Model.init_cache`` / ``init_train_state``
    on a ``meta`` model."""
    B, S = shape.global_batch, shape.seq_len
    dt = _dtype(cfg)

    def sd(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        batch = {"tokens": sd((B, S + 1), torch.int32)}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = sd((B, cfg.n_patches, cfg.d_model), dt)
        if cfg.is_encoder_decoder:
            batch["encoder_frames"] = sd((B, cfg.encoder_positions, cfg.d_model), dt)
    elif shape.kind == "prefill":
        batch = {"tokens": sd((B, S), torch.int32)}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = sd((B, cfg.n_patches, cfg.d_model), dt)
        if cfg.is_encoder_decoder:
            batch["encoder_frames"] = sd((B, cfg.encoder_positions, cfg.d_model), dt)
    else:  # decode: one new token against a cache of seq_len
        batch = {
            "tokens": sd((B, 1), torch.int32),
            "cache_len": sd((B,), torch.int32),
        }
    return batch
