"""§Perf hillclimb: trace tagged variants of chosen cells and
compare their roofline terms against the baseline artifact.

PyTorch port of :mod:`repro.launch.hillclimb`, over the port's
:func:`~repro_torch.launch.dryrun.run_cell` (a fake world on ``meta``; no
hardware).  Variants (napkin math in EXPERIMENTS.md §Perf):

* ``ep``        — expert-parallel MoE (experts over the model axis) instead
                  of baseline TP-MoE: removes the per-device [B,E·C,D]
                  dispatch all-gather; valid when E % 16 == 0.
* ``mb<k>``     — k gradient-accumulation microbatches (activation peak ÷ k,
                  slight compute overhead from per-microbatch re-reads).
* ``noremat``   — disable activation checkpointing (−~30% recompute FLOPs,
                  + saved-activation memory): for compute-bound cells with
                  HBM headroom.
* ``kvint8``    — int8 KV cache with per-(token,head) scales: halves the
                  decode memory term (beyond-paper; production-standard).
* ``nosp`` / ``mb<k>nosp`` — disable sequence parallelism (the SP all-
                  gathers around every chunked attention dominate the
                  collective term); microbatches recover the memory SP won.
* ``seqdata``   — bind the activation seq axis to ('data','model') for
                  long-context prefill (2-D sequence parallelism).
* ``kvboth``    — shard decode KV cache seq over both axes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --arch granite-moe-1b-a400m --shape train_4k --variant ep
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

from ..configs import get_config
from ..models.sharding import make_rules
from .dryrun import ART_DIR, cell_rules, ep_rules, run_cell


def variant_spec(name: str, arch: str, shape: str):
    """``(config override or None, rules function or None)`` of a variant."""
    cfg = get_config(arch)
    if name == "ep":
        return None, ep_rules(shape)
    if name in ("nosp", "mb4nosp", "mb2nosp", "mb8nosp"):
        pass  # handled below (before the generic mb<k> parse)
    elif name.startswith("mb"):
        k = int(name[2:])
        return cfg.replace(n_microbatches=k), None
    if name == "noremat":
        return cfg.replace(remat=False), None
    if name == "kvint8":
        return cfg.replace(kv_cache_dtype="int8"), None
    if name in ("nosp", "mb4nosp", "mb2nosp"):
        def rules(mesh):
            base = cell_rules(mesh, shape)
            over = dict(base.rules)
            over["seq"] = None    # no sequence parallelism: kills per-chunk
            return make_rules(mesh, **over)  # activation re-gathers
        cfg2 = None
        if name.startswith("mb"):
            cfg2 = cfg.replace(n_microbatches=int(name[2]))
        return cfg2, rules
    if name == "seqdata":
        def rules(mesh):
            base = cell_rules(mesh, shape)
            over = dict(base.rules)
            over["seq"] = ("data", "model")
            over["batch"] = None
            return make_rules(mesh, **over)
        return None, rules
    if name == "kvboth":
        def rules(mesh):
            base = cell_rules(mesh, shape)
            over = dict(base.rules)
            over["kv_seq"] = ("data", "model")
            over["batch"] = None
            return make_rules(mesh, **over)
        return None, rules
    raise SystemExit(f"unknown variant {name}")


def compare(base: dict, var: dict, label: str) -> None:
    b, v = base["roofline"], var["roofline"]
    bm = base["memory"]["peak_estimate_bytes"] / 2**30
    vm = var["memory"]["peak_estimate_bytes"] / 2**30
    print(f"\n=== {label} ===")
    print(f"{'term':<12}{'baseline':>14}{'variant':>14}{'delta':>10}")
    for key, name in (("t_compute_s", "compute"), ("t_memory_s", "memory"),
                      ("t_collective_s", "collective")):
        d = (v[key] - b[key]) / max(b[key], 1e-12) * 100
        print(f"{name:<12}{b[key]:>13.4f}s{v[key]:>13.4f}s{d:>+9.1f}%")
    print(f"{'mem GiB':<12}{bm:>14.2f}{vm:>14.2f}"
          f"{(vm - bm) / max(bm, 1e-9) * 100:>+9.1f}%")
    print(f"{'dominant':<12}{b['dominant']:>14}{v['dominant']:>14}")
    print(f"{'frac':<12}{b['roofline_fraction']:>14.3f}"
          f"{v['roofline_fraction']:>14.3f}")


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    base_path = ART_DIR / f"{args.arch}__{args.shape}__{args.mesh}.json"
    if not base_path.exists():
        run_cell(args.arch, args.shape, args.mesh)
    base = json.loads(base_path.read_text())

    cfg_over, rules_over = variant_spec(args.variant, args.arch, args.shape)
    var = run_cell(args.arch, args.shape, args.mesh, force=args.force,
                   rules_override=rules_over, cfg_override=cfg_over,
                   tag=f"__{args.variant}")
    compare(base, var, f"{args.arch} × {args.shape} × {args.mesh} "
                       f"[{args.variant}]")


if __name__ == "__main__":
    main()
