#!/usr/bin/env python3
"""Time the port's fault-tolerant training example on one CUDA card.

Usage, from the root of a checkout, on a machine with a card::

    python3 train_ft_timed.py [--preset 100m] [--steps 60]

Runs ``examples_torch/train_ft.py``'s ``main`` in this process with
``--device cuda`` (its own lines are printed as it prints them) and times
it by wrapping, at call time, the names its trainer looks up: a step opens
when ``runtime.ft.DeltaAggregator`` is built and its compute ends when
``runtime.ft.adamw_update`` returns; ``FTTrainer.checkpoint`` and
``FTTrainer.restore`` are timed on their own.  The card is synchronised at
every mark.  It prints the card's name and power limit, then one JSON
line: each step's ms, the saves' and the restore's seconds, the
checkpoint store's bytes, the card's peak memory and the host's peak RSS.
It imports neither ``jax`` nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


class TrainerClock(contextlib.AbstractContextManager):
    """While installed: each step's seconds, each save's and restore's, and
    the trainers built; the wrapped names are restored on exit."""

    def __init__(self, torch):
        from repro_torch.runtime import ft

        self.torch, self.ft = torch, ft
        self.steps, self.saves, self.restores, self.trainers = [], [], [], []
        self._opened = None

    def _mark(self) -> float:
        self.torch.cuda.synchronize()
        return time.perf_counter()

    def __enter__(self):
        ft, cls = self.ft, self.ft.FTTrainer
        self._real = (ft.DeltaAggregator, ft.adamw_update, cls.__init__,
                      cls.checkpoint, cls.restore)
        agg, update, init, save, restore = self._real

        def open_step(*args, **kw):
            self._opened = self._mark()
            return agg(*args, **kw)

        def close_step(*args, **kw):
            out = update(*args, **kw)
            self.steps.append(self._mark() - self._opened)
            return out

        def timed(fn, into):
            def call(*args, **kw):
                t0 = self._mark()
                out = fn(*args, **kw)
                into.append(self._mark() - t0)
                return out
            return call

        def built(trainer, *args, **kw):
            init(trainer, *args, **kw)
            self.trainers.append(trainer)

        ft.DeltaAggregator, ft.adamw_update = open_step, close_step
        cls.__init__, cls.checkpoint = built, timed(save, self.saves)
        cls.restore = timed(restore, self.restores)
        return self

    def __exit__(self, *exc):
        ft, cls = self.ft, self.ft.FTTrainer
        (ft.DeltaAggregator, ft.adamw_update, cls.__init__, cls.checkpoint,
         cls.restore) = self._real
        return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="100m")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.tree import leaves

    if not torch.cuda.is_available():
        print("train_ft_timed: no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[device] {card}", flush=True)
    spec = importlib.util.spec_from_file_location(
        "train_ft", ROOT / "examples_torch" / "train_ft.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)

    t0 = time.perf_counter()
    with TrainerClock(torch) as clock:
        example.main(["--preset", args.preset, "--steps", str(args.steps),
                      "--device", "cuda"])
    seconds = time.perf_counter() - t0
    (trainer,) = clock.trainers
    steps_ms = [s * 1e3 for s in clock.steps]
    warm = sorted(steps_ms[1:])
    print(json.dumps({
        "preset": args.preset, "steps": len(steps_ms), "card": card,
        "seconds": seconds,
        "params": sum(x.numel() for x in leaves(trainer.state.params)),
        "step_ms": steps_ms,
        "first_step_ms": steps_ms[0],
        "warm_step_ms_median": warm[len(warm) // 2],
        "warm_step_ms_min": warm[0], "warm_step_ms_max": warm[-1],
        "tokens_per_step": trainer.ft.global_batch * trainer.ft.seq_len,
        "save_s": clock.saves, "restore_s": clock.restores,
        "store_bytes": trainer.store.total_bytes(),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "host_peak_rss_gb":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
