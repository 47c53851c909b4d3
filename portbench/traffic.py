"""The one generator of traffic: it reads a mix's parameters
(``traffic/<name>.json``) and the seed, and makes the requests or batches.

Serving: an endless stream of requests.  Prompt lengths come in blocks of
``stratified_per``: each block holds the same lengths (the block's
quantiles of the stated distribution), in an order drawn from the seed, so
every seed offers the same work in another order.  Token ids are drawn
from the seed, request by request.  Training: batch ``k`` is ``rows`` x
``seq`` token ids drawn on the device from ``(seed, k)``, so no two steps
see the same rows.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def block_lengths(spec: dict) -> List[int]:
    """The lengths of one block, in ascending order."""
    n = int(spec["stratified_per"])
    lo, hi = float(spec["lo"]), float(spec["hi"])
    if spec["dist"] != "log_uniform":
        raise ValueError(f"no distribution {spec['dist']!r}")
    return [int(round(math.exp(math.log(lo) + (i + 0.5) / n
                               * (math.log(hi) - math.log(lo)))))
            for i in range(n)]


class RequestStream:
    """Requests ``0, 1, 2, ...`` of a serving mix for one seed; warm-up
    requests come from a separate stream (``warm=True``)."""

    def __init__(self, traffic: dict, vocab: int, seed: int,
                 warm: bool = False):
        self.lengths = block_lengths(traffic["prompt_len"])
        self.vocab = vocab
        self.seed = int(seed)
        self.salt = 1 if warm else 0
        self.i = 0

    def length(self, i: int) -> int:
        per = len(self.lengths)
        order = np.random.default_rng(
            [self.seed, self.salt, 7, i // per]).permutation(per)
        return self.lengths[int(order[i % per])]

    def prompt(self, i: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, self.salt, 11, i])
        return rng.integers(0, self.vocab, self.length(i), dtype=np.int32)

    def next(self) -> np.ndarray:
        out = self.prompt(self.i)
        self.i += 1
        return out


def train_batch(traffic: dict, vocab: int, seed: int, k: int,
                device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_033 + 104_729 * (k + 1)) % (2 ** 63 - 1))
    return torch.randint(0, vocab, (int(traffic["rows"]), int(traffic["seq"])),
                         generator=gen, device=device, dtype=torch.int32)
