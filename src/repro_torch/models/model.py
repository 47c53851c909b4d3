"""Public Model API: init / train_step / prefill_step / decode_step.

PyTorch port of :mod:`repro.models.model`.  The cross-entropy is computed
**chunked over the sequence** (``CE_CHUNK`` positions at a time, fp32
``logsumexp``), so the ``[B, T, vocab]`` logits tensor never
materialises; under autograd each chunk runs in ``torch.utils.checkpoint``
and is recomputed in the backward, so the ``[B, CE_CHUNK, vocab]`` fp32
logits of one chunk at a time are alive, not of all.  Prefill computes
logits for the final position only.

Training follows the JAX package's functional API (``loss_fn``,
``grad_step``, ``train_step`` over a :class:`TrainState`), with one
difference: ``train_step`` and :func:`~repro_torch.train.optimizer.adamw_update`
update the parameters and moments in place and return them, where JAX
returns new trees (at ``minitron-4b``'s width a second copy of the state
would not fit the card).  ``loss_fn`` adds ``0.01 *`` the MoE layers'
load-balance loss to the cross-entropy, as the JAX ``loss_fn`` does;
``prefill_step`` and ``decode_step`` drop it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..train.optimizer import AdamWConfig, adamw_update, init_opt_state
from ..tree import leaves, map_tree
from .sharding import constrain, is_dtensor, local_kernel, local_rows
from .transformer import forward, init_decode_cache, init_params, lm_logits

CE_CHUNK = 512


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor            # int32, 0-d


def _gold(logits: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``logits[b, i, t[b, i]]``; for DTensors, on each rank's rows (the
    gather has no DTensor strategy but replication: its backward would
    zero a whole-batch ``[B, chunk, vocab]`` on every rank)."""
    if is_dtensor(logits):
        lg = ("batch", "ce_seq", None)
        return local_kernel(_gold, (logits, t), (lg, lg[:2]),
                            ((tuple(t.shape), lg[:2]),))
    return torch.gather(logits, -1, t[..., None])[..., 0]


def _chunk_loss(params, cfg: ModelConfig, h: torch.Tensor, t: torch.Tensor,
                m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    # shard the chunk's sequence dim over the model axis so the
    # [B, chunk, V] logits are distributed even where the vocab does not
    # divide the mesh (granite's and whisper's vocabs)
    h = constrain(h, "batch", "ce_seq", "embed")
    logits = lm_logits(params, cfg, h).float()
    logits = constrain(logits, "batch", "ce_seq", None)
    logz = torch.logsumexp(logits, dim=-1)
    gold = _gold(logits, t.long())
    return ((logz - gold) * m).sum(), m.sum()


def cross_entropy(params, cfg: ModelConfig, hidden: torch.Tensor,
                  targets: torch.Tensor, mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Chunked CE over the sequence.  hidden [B,T,D], targets int[B,T]."""
    B, T, _ = hidden.shape
    chunk = min(CE_CHUNK, T)
    n = T // chunk
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=hidden.device)
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if T - n * chunk:
        bounds.append((n * chunk, T))
    remat = torch.is_grad_enabled()
    total, cnt = 0.0, 0.0
    for lo, hi in bounds:
        args = (params, cfg, hidden[:, lo:hi], targets[:, lo:hi],
                mask[:, lo:hi])
        if remat:
            l, c = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            l, c = _chunk_loss(*args)
        total, cnt = total + l, cnt + c
    return total / torch.clamp(cnt, min=1.0)


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (the data-parallel
    reduction: a partial sum reduced, scattered to the parameter's
    shards); a plain one as it is."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _split(batch: Dict[str, torch.Tensor], mbs: int):
    for name, leaf in batch.items():
        if leaf.shape[0] % mbs != 0:
            raise ValueError(
                f"batch {leaf.shape[0]} ({name}) not divisible by {mbs} "
                "microbatches")
    return [{name: local_rows(leaf, mbs, i) if is_dtensor(leaf) else
             leaf.reshape((mbs, leaf.shape[0] // mbs)
                          + tuple(leaf.shape[1:]))[i]
             for name, leaf in batch.items()} for i in range(mbs)]


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    opt_cfg: AdamWConfig = AdamWConfig()

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> Dict:
        """Random parameters on the model's device, from ``seed``; on
        ``meta``, their shapes and types only (a CPU generator stands in:
        PyTorch has none for ``meta``)."""
        meta = self.device.type == "meta"
        gen = torch.Generator(device="cpu" if meta else self.device)
        gen.manual_seed(seed)
        with torch.no_grad():
            return init_params(gen, self.cfg, self.device)

    def init_train_state(self, seed: int = 0) -> TrainState:
        params = self.init(seed)
        opt = init_opt_state(params, self.opt_cfg)
        return TrainState(params, opt,
                          torch.zeros((), dtype=torch.int32,
                                      device=self.device))

    def init_cache(self, batch: int, length: int) -> Dict:
        return init_decode_cache(self.cfg, batch, length, self.device)

    # ------------------------------------------------------------ train step
    def loss_fn(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        tokens = batch["tokens"]
        inp, tgt = tokens[:, :-1], tokens[:, 1:]
        hidden, _, aux = forward(params, cfg, inp, mode="train",
                                 patch_embeds=batch.get("patch_embeds"),
                                 encoder_frames=batch.get("encoder_frames"),
                                 return_hidden=True)
        ce = cross_entropy(params, cfg, hidden, tgt, batch.get("mask"))
        return ce + 0.01 * aux

    def grad_step(self, params, batch) -> Tuple[torch.Tensor, Any]:
        """Loss + grads only (for delta-sync / accumulation drivers):
        ``(loss, grads)``, grads a tree of ``params``' structure."""
        live = map_tree(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss = self.loss_fn(live, batch)
            flat = leaves(live)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        it = iter([_placed_like(g, p) if g is not None else torch.zeros_like(p)
                   for p, g in zip(flat, grads)])
        return loss.detach(), map_tree(lambda _: next(it), live)

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        mbs = self.cfg.n_microbatches
        if mbs <= 1:
            loss, grads = self.grad_step(state.params, batch)
        else:
            # gradient accumulation over microbatches, fp32 accumulators
            gsum = map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                            state.params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            for mb in _split(batch, mbs):
                l, grads = self.grad_step(state.params, mb)
                for a, g in zip(leaves(gsum), leaves(grads)):
                    a.add_(g.float())
                loss_sum = loss_sum + l
                del grads
            loss = loss_sum / mbs
            for a in leaves(gsum):
                a.div_(mbs)
            grads = gsum
        new_params, new_opt = adamw_update(
            grads, state.opt, state.params, self.opt_cfg)
        metrics = {"loss": loss, "step": state.step + 1}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    # ------------------------------------------------------------ serve steps
    @torch.no_grad()
    def prefill_step(self, params, batch: Dict[str, torch.Tensor],
                     max_len: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        """(logits of the last position ``[B, vocab]``, a fresh cache of
        capacity ``max_len``).  ``batch`` holds ``tokens`` and, for a vision
        frontend, ``patch_embeds``; for an encoder-decoder,
        ``encoder_frames``."""
        tokens = batch["tokens"]
        hidden, cache, _ = forward(
            params, self.cfg, tokens, mode="prefill",
            patch_embeds=batch.get("patch_embeds"),
            encoder_frames=batch.get("encoder_frames"), return_hidden=True,
            max_cache_len=max_len or tokens.shape[1] + 64)
        logits = lm_logits(params, self.cfg, hidden[:, -1:, :])[:, 0, :]
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor,
                    cache_len: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """(logits ``[B, vocab]``, ``cache`` updated in place)."""
        hidden, new_cache, _ = forward(
            params, self.cfg, tokens, mode="decode", cache=cache,
            cache_len=cache_len, return_hidden=True)
        logits = lm_logits(params, self.cfg, hidden)[:, 0, :]
        return logits, new_cache


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                opt_cfg: Optional[AdamWConfig] = None) -> Model:
    """The model of ``cfg`` on ``device`` (the card unless ``"cpu"``)."""
    if opt_cfg is None:
        opt_cfg = AdamWConfig(moments=cfg.optimizer_moments)
    return Model(cfg, resolve_device(device), opt_cfg)

