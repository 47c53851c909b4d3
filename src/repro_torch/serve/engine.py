"""Batched serving engine: continuous-batching decode over a shared cache.

PyTorch port of :mod:`repro.serve.engine`.  Request lifecycle: enqueue →
prefill (one call per admission, its cache spliced into the slot's
pre-allocated max-length cache) → step the whole batch with one decode step
per token → stream tokens out → free the slot on EOS/limit.  Greedy
(``argmax``, the first maximum) or temperature sampling from a seeded
:class:`torch.Generator` (other draws than ``jax.random``).

The engine owns its cache and updates it in place: the splice copies into
the slot, and a decode step writes each row's new K and V into its ring
slot, or each Mamba layer's conv window and state.  ``cache_len`` stays on
the device, and advances for SSM slots too, as in the JAX package.

An encoder-decoder is refused: admission prefills tokens alone, so the
JAX package's engine cannot serve one either (its serve launcher refuses
it).  Serve it through ``Model.prefill_step`` with ``encoder_frames``,
then ``Model.decode_step``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models import build_model
from ..models.transformer import init_decode_cache


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # int32[T]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_len: int = 256, temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None):
        if cfg.is_encoder_decoder:
            raise ValueError(
                f"{cfg.name}: the engine prefills without encoder frames; "
                "serve an encoder-decoder through Model.prefill_step with "
                "encoder_frames and Model.decode_step")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.cache = init_decode_cache(cfg, max_batch, max_len, self.device)
        self.cache_len = torch.zeros((max_batch,), dtype=torch.int32,
                                     device=self.device)
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: List[Request] = []
        self._next_rid = 0

    # ------------------------------------------------------------- frontend
    def submit(self, prompt: np.ndarray, **kw) -> Request:
        req = Request(self._next_rid, np.asarray(prompt, np.int32), **kw)
        self._next_rid += 1
        self.queue.append(req)
        return req

    # ------------------------------------------------------------ admission
    def _admit(self) -> None:
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            self.slots[slot] = req
            T = len(req.prompt)
            tokens = torch.as_tensor(req.prompt[None, :], device=self.device)
            logits, pf_cache = self.model.prefill_step(
                self.params, {"tokens": tokens}, max_len=self.max_len)
            _splice_cache(self.cache, pf_cache, slot)
            self.cache_len[slot] = T
            req.out_tokens.append(self._sample(logits[0:1])[0])

    def _sample(self, logits: torch.Tensor) -> List[int]:
        """One token per row of ``logits [n, vocab]``."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1).tolist()
        probs = F.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)[:, 0].tolist()

    # ----------------------------------------------------------------- step
    def step(self) -> int:
        """One engine iteration: admit, decode one token for every active
        slot, retire finished requests.  Returns #active slots."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        last = np.zeros((self.max_batch, 1), np.int32)
        for i in active:
            last[i, 0] = self.slots[i].out_tokens[-1]
        logits, self.cache = self.model.decode_step(
            self.params, self.cache, torch.as_tensor(last, device=self.device),
            self.cache_len)
        self.cache_len += torch.tensor(
            [1 if self.slots[i] is not None else 0
             for i in range(self.max_batch)], dtype=torch.int32,
            device=self.device)
        toks = self._sample(logits[active])
        for i, tok in zip(active, toks):
            req = self.slots[i]
            req.out_tokens.append(tok)
            if (req.eos_id is not None and tok == req.eos_id) or \
                    len(req.out_tokens) >= req.max_new_tokens:
                req.done = True
                self.slots[i] = None
        return len(active)

    def run_until_drained(self, max_iters: int = 10_000) -> None:
        it = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and it < max_iters:
            self.step()
            it += 1


def _splice_cache(cache: Dict, pf_cache: Dict, slot: int) -> Dict:
    """Copy a prefilled single-request cache into batch position ``slot``,
    in place.

    Grouped cache leaves carry ``[n_groups, B, ...]``; tail leaves carry
    ``[B, ...]`` — the batch axis comes from the path.  The other axes are
    padded (with zeros at the end) or sliced to the buffer's, as in the JAX
    package: a prompt shorter than the Mamba conv window leaves its history
    rows first and the zeros after them (ROADMAP C5).
    """
    def visit(head: str, buf: torch.Tensor, new: torch.Tensor) -> None:
        baxis = 1 if head == "groups" else 0
        n = new
        for axis in range(buf.dim()):
            if axis == baxis:
                continue
            if n.shape[axis] < buf.shape[axis]:
                width = [0, 0] * n.dim()
                # F.pad lists (left, right) pairs from the last axis back
                width[2 * (n.dim() - 1 - axis) + 1] = buf.shape[axis] - n.shape[axis]
                n = F.pad(n, width)
            elif n.shape[axis] > buf.shape[axis]:
                n = n.narrow(axis, 0, buf.shape[axis])
        buf.narrow(baxis, slot, 1).copy_(n)

    for head, layers in cache.items():
        if head not in ("groups", "tail"):
            continue
        for buf_layer, new_layer in zip(layers, pf_cache[head]):
            for name, buf in buf_layer.items():
                visit(head, buf, new_layer[name])
    return cache
