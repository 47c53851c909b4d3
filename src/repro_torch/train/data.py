"""Deterministic synthetic data pipeline.

Sharded, seekable token stream: batch i is a pure function of (seed, step,
host), so restarts and elastic re-sharding reproduce the exact stream — a
prerequisite for the bit-equal restore test and for straggler backfill.
A light zipf-mixture LM task (order-2 markov over a small alphabet) gives a
learnable signal so examples/train_100m.py shows a real loss curve.

PyTorch port: a copy of :mod:`repro.train.data` (numpy only, so the
batches are bit-identical); everything below this docstring is unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 2
    n_states: int = 64


class SyntheticLM:
    """Order-k markov chain over a vocab-projected state space."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n = cfg.n_states
        # sparse-ish transition matrix with zipf stationary mass
        probs = rng.dirichlet(np.full(n, 0.3), size=n)
        self.trans = probs
        self.proj = rng.integers(0, cfg.vocab_size, size=n)

    def batch(self, step: int, *, host: int = 0, n_hosts: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4099 + host)
        n = cfg.n_states
        B, T = per_host, cfg.seq_len + 1
        states = np.empty((B, T), np.int64)
        states[:, 0] = rng.integers(0, n, B)
        u = rng.random((B, T))
        cum = np.cumsum(self.trans, axis=1)
        for t in range(1, T):
            row = cum[states[:, t - 1]]
            states[:, t] = (u[:, t : t + 1] < row).argmax(axis=1)
        tokens = self.proj[states].astype(np.int32)
        return {"tokens": tokens}

    def stream(self, start_step: int = 0, **kw) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step, **kw)
            step += 1
