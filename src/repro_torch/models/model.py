"""Public Model API: init / prefill_step / decode_step.

PyTorch port of the serve half of :mod:`repro.models.model`; prefill
computes logits for the final position only, so the ``[B, T, vocab]``
tensor never materialises.  ``loss_fn``, ``train_step`` and the chunked
cross-entropy come with the training slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from .transformer import forward, init_decode_cache, init_params, lm_logits


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    # ------------------------------------------------------------------ init
    def init(self, seed: int = 0) -> Dict:
        """Random parameters on the model's device, from ``seed``."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with torch.no_grad():
            return init_params(gen, self.cfg)

    def init_cache(self, batch: int, length: int) -> Dict:
        return init_decode_cache(self.cfg, batch, length, self.device)

    # ------------------------------------------------------------ serve steps
    @torch.no_grad()
    def prefill_step(self, params, batch: Dict[str, torch.Tensor],
                     max_len: Optional[int] = None) -> Tuple[torch.Tensor, Any]:
        """(logits of the last position ``[B, vocab]``, a fresh cache of
        capacity ``max_len``).  ``batch`` holds ``tokens`` and, for a vision
        frontend, ``patch_embeds``."""
        tokens = batch["tokens"]
        hidden, cache = forward(
            params, self.cfg, tokens, mode="prefill",
            patch_embeds=batch.get("patch_embeds"), return_hidden=True,
            max_cache_len=max_len or tokens.shape[1] + 64)
        logits = lm_logits(params, self.cfg, hidden[:, -1:, :])[:, 0, :]
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor,
                    cache_len: torch.Tensor) -> Tuple[torch.Tensor, Any]:
        """(logits ``[B, vocab]``, ``cache`` updated in place)."""
        hidden, new_cache = forward(
            params, self.cfg, tokens, mode="decode", cache=cache,
            cache_len=cache_len, return_hidden=True)
        logits = lm_logits(params, self.cfg, hidden)[:, 0, :]
        return logits, new_cache


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    """The model of ``cfg`` on ``device`` (the card unless ``"cpu"``)."""
    return Model(cfg, resolve_device(device))

