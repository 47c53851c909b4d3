"""The readings that a cell's limits are set from, on the chip, in one
process: the program's numbers over many seeds, and on some of them the
control (the plain reference computed in float8 in the program's place)
and, for a training cell, the planted faults.

    python3 -m portbench.calibrate --workload <name> --seconds <s> \
        --seeds 11,12,... [--control 11,12,13] [--out file.jsonl]

Each seed runs the cell's window (``--seconds`` long) and its comparison
as the benchmark does, and prints one JSON line: the numbers compared, the
end-to-end metrics, and where asked the control's and the faults' numbers.
A serving cell's control reads, at each position of the sampled requests,
the reference's gap of the token that the float8 pass puts first.  A
training cell's control is the float8 reference's first steps; its
``half_batch`` fault is the reference's steps on the first half of each
batch; a step that returns its state unchanged reads 1 by the change's
measure and is not run.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch


def serve_control(cell, seed, checked, device):
    """The float8 pass over the check's own sample: at each position the
    reference's gap of the token the float8 pass puts first; and the gap
    of each served token bumped by one (a token altered where it is
    produced)."""
    from . import reference
    from .serve import gaps
    seqs, wanted, served = checked["sample"]
    ref = checked["logits"]
    low = reference.served_logits(cell.spec, seed, device, seqs, wanted, "fp8")
    ctrl = torch.cat([gaps(r, lo.argmax(-1)) for r, lo in zip(ref, low)])
    alt = torch.cat([gaps(r, (tok.to(r.device).long() + 1) % r.shape[-1])
                     for r, tok in zip(ref, served)])
    return {"control_widest_gap": float(ctrl.max()),
            "control_mean_gap": float(ctrl.mean()),
            "control_off_top": float((ctrl > 0).float().mean()),
            "altered_token_widest_gap": float(alt.max()),
            "altered_token_least_gap": float(alt.min())}


def train_control(cell, seed, device):
    from . import reference
    from .train import compare
    from .traffic import train_batch
    t = cell.traffic
    batches = [train_batch(t, cell.spec.vocab, seed, k, device)
               for k in range(int(t["check_steps"]))]
    ref = reference.train_reference(cell.spec, seed, device, batches,
                                    t["optimizer"], "fp32")
    out = {}
    low = reference.train_reference(cell.spec, seed, device, batches,
                                    t["optimizer"], "fp8")
    out["control"] = compare(low, ref, detail=True)
    del low
    gc.collect()
    half = [b[: max(1, b.shape[0] // 2)] for b in batches]
    hb = reference.train_reference(cell.spec, seed, device, half,
                                   t["optimizer"], "fp32")
    out["half_batch"] = compare(hb, ref, detail=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=12)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from .run import prepare_env, run_cell
    prepare_env()
    from . import serve, spec as specs, train
    cell = specs.cell(args.workload)
    device = torch.device("cuda")
    ctrl_seeds = {int(s) for s in args.control.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    base = {"serve": serve, "train": train}[cell.kind]
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        kept = {}

        class Keep:
            """The cell's driver, keeping the comparison's detail."""
            run = staticmethod(base.run)

            @staticmethod
            def check(*a, **kw):
                kept.update(base.check(*a, detail=True, **kw))
                return kept

        res = run_cell(args.workload, seed, args.seconds, False, device,
                       cell=cell, driver=Keep, clock=lambda: 0.0)
        line = {"workload": args.workload, "seed": seed,
                "checked": {k: v["value"] for k, v in res["checked"].items()},
                "detail": {k: v for k, v in kept.items()
                           if k not in ("logits", "sample")},
                "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                "device": res["device"]}
        if seed in ctrl_seeds:
            if cell.kind == "serve":
                line.update(serve_control(cell, seed, kept, device))
            else:
                kept.clear()
                gc.collect()
                torch.cuda.empty_cache()
                line.update(train_control(cell, seed, device))
        kept.clear()
        gc.collect()
        torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
