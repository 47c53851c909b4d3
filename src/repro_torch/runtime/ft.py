"""Fault-tolerant training driver (single-process simulation of a DP fleet).

Composes every plane the framework provides:

* **model step** — a real jit'd train step over host-local batches, with
  host gradients folded through the dot-tracked :class:`DeltaAggregator`
  (dedup, quorum, straggler sealing);
* **durability** — BigStore decomposed delta checkpoints every
  ``ckpt_every`` steps (each host saves its own shard slice);
* **elasticity** — membership-CRDT assignment; hosts can crash/join
  between steps, batches re-partition, state restores from a quorum;
* **determinism** — the seekable data pipeline makes post-restore
  training bit-comparable to an uninterrupted run (tested).

This is a *simulation harness* (hosts are objects, not processes), but the
decision logic is exactly what each real host would run.

PyTorch port of :mod:`repro.runtime.ft`.  The step is a plain call of
``grad_step`` (no ``jax.jit``), the state is drawn from a seeded
generator, batches are tensors on the trainer's ``device`` (the card
unless ``"cpu"``), and each host's gradients go to the aggregator, which
sums them in place, so one gradient tree a step stays in flight beside
the running sum.  On the card the steps run under
``torch.use_deterministic_algorithms``, enforced (the embedding's
backward would otherwise accumulate with atomics in no fixed order, and an
operation with no deterministic version raises), and the attention
kernels use no atomics, so a restored run repeats the uninterrupted one
bit for bit.
"""
from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from ..checkpoint.bigstore import BigStore
from ..checkpoint.manager import (flatten_state, state_shard_names,
                                  unflatten_state)
from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..models import build_model
from ..models.model import TrainState
from ..train.data import DataConfig, SyntheticLM
from ..train.delta_sync import DeltaAggregator, GradDelta
from ..train.optimizer import adamw_update
from .elastic import ElasticController


@dataclass
class FTConfig:
    n_hosts: int = 4
    global_batch: int = 8
    seq_len: int = 32
    ckpt_every: int = 5
    replication: int = 3
    quorum_frac: float = 0.75  # straggler sealing quorum
    seed: int = 0


CUBLAS_WORKSPACE = "CUBLAS_WORKSPACE_CONFIG"


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms on the card for the duration, enforced: an
    operation with no deterministic implementation raises.  cuBLAS counts
    as deterministic only under a fixed workspace, so
    ``CUBLAS_WORKSPACE_CONFIG`` is set to ``:4096:8`` unless the caller set
    it.  Both settings are process-wide and are put back after."""
    if device.type != "cuda":
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    workspace = os.environ.get(CUBLAS_WORKSPACE)
    if workspace is None:
        os.environ[CUBLAS_WORKSPACE] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
        if workspace is None:
            del os.environ[CUBLAS_WORKSPACE]


class FTTrainer:
    def __init__(self, cfg: ModelConfig, ft: FTConfig,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.ft = ft
        self.device = resolve_device(device)
        self.model = build_model(cfg, self.device)
        self.data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=ft.seq_len,
            global_batch=ft.global_batch, seed=ft.seed))
        self.state: TrainState = self.model.init_train_state(ft.seed)
        self.store = BigStore(ft.n_hosts, replication=ft.replication)
        self.elastic = ElasticController(ft.n_hosts, ft.global_batch)
        self.step = 0
        self.grad_fn = self.model.grad_step
        self.loss_history: List[float] = []

    # ------------------------------------------------------------- stepping
    def _host_batch(self, host: str, assignment, step: int):
        lo, hi = assignment.batch_slices[host]
        full = self.data.batch(step)
        return {k: torch.as_tensor(v[lo:hi], device=self.device)
                for k, v in full.items()}, hi - lo

    def train_steps(self, n: int, *, slow_hosts: Dict[str, int] | None = None
                    ) -> List[float]:
        """Run n steps; ``slow_hosts`` maps host -> steps of lateness
        (their contribution misses the deadline and is sealed out)."""
        slow_hosts = slow_hosts or {}
        losses = []
        for _ in range(n):
            assignment = self.elastic.current_assignment()
            hosts = list(assignment.hosts)
            agg = DeltaAggregator(
                hosts, quorum=max(1, int(len(hosts) * self.ft.quorum_frac)))
            losses_this = []
            for host in hosts:
                if slow_hosts.get(host, 0) > 0:
                    slow_hosts[host] -= 1
                    continue  # misses the deadline this step
                batch, n_samples = self._host_batch(host, assignment, self.step)
                with deterministic(self.device):
                    loss, grads = self.grad_fn(self.state.params, batch)
                agg.offer(GradDelta(host, self.step, n_samples, grads))
                del grads  # the aggregator holds the step's one sum
                losses_this.append(float(loss))
            mean_grads, n_contrib = agg.seal(self.step)
            new_params, new_opt = adamw_update(
                mean_grads, self.state.opt, self.state.params,
                self.model.opt_cfg)
            del mean_grads
            self.state = TrainState(new_params, new_opt, self.state.step + 1)
            self.step += 1
            loss = float(np.mean(losses_this)) if losses_this else float("nan")
            losses.append(loss)
            self.loss_history.append(loss)
            if self.step % self.ft.ckpt_every == 0:
                self.checkpoint()
        return losses

    # ----------------------------------------------------------- durability
    def checkpoint(self) -> Dict[str, int]:
        shards = flatten_state(self.state)
        return self.store.save(b"run0", shards, self.step)

    def crash_host(self, idx: int, detected_by: str = "node0") -> None:
        self.store.kill(idx)
        self.elastic.fail(f"node{idx}", detected_by)

    def join_host(self, idx: int) -> None:
        self.store.revive(idx)
        self.elastic.scale_up(f"node{idx}")

    def restore(self) -> int:
        expect = state_shard_names(self.state)
        shards = self.store.restore(b"run0", expect=expect)
        step = max(s for s, _ in shards.values())
        self.state = unflatten_state(self.state, shards)
        self.step = step
        return step
