"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a ``torch.profiler`` trace of the window.  Either way, once the
window has closed and the program's state is freed, what the window
produced is compared with the plain reference (``correct``), and each
number compared is printed beside its limit, last on standard error and
last in the line.  The run refuses to start without the card(s) the cell
asks for, and fails if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
from pathlib import Path

_T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (from ``/proc``), else since
    this module was loaded."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - start_ticks / os.sysconf("SC_CLK_TCK")
        if 0 <= age < 3600:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _T0


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def prepare_env() -> None:
    """Fixed build and cache directories inside the checkout, the
    program's package on the path, and no JAX behind a library."""
    cache = ROOT / ".portbench_cache"
    os.environ.setdefault("REPRO_TORCH_BUILD_DIR",
                          str(ROOT / "src" / "repro_torch" / "kernels" / "_build"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def fed_of(kind: str, out: dict, traffic: dict) -> dict:
    if kind == "serve":
        return {"kind": "serve", "prefill_lens": out["prefill_lens"],
                "decode_ctx": out["decode_ctx"],
                "decode_tokens": out["decode_tokens"],
                "decode_rows": out["decode_rows"]}
    return {"kind": "train", "steps": out["steps"], "rows": traffic["rows"],
            "seq": traffic["seq"]}


def compare(cell, checked: dict, counts: dict, fed: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})``: every figure against
    its limit (``checks/<workload>.json``), then each kernel's calls in
    the window: all of them on the CUDA kernel, as many as the fed work
    makes."""
    from . import work
    rows = {}
    ok = True
    for name, lim in cell.limits["compare"].items():
        value = checked.get(name)
        limit = lim.get("limit")
        rows[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None \
            and math.isfinite(value) and value <= limit
    for k in cell.limits["kernels"]:
        want = len(work.module(k).calls(cell.spec, fed))
        got = counts[k]
        rows[f"{k}_calls"] = {"value": got["kernel_calls"], "limit": want}
        rows[f"{k}_plain_calls"] = {"value": got["calls"] - got["kernel_calls"],
                                    "limit": 0}
        ok = ok and got["kernel_calls"] == want and got["calls"] == want
    return ok, rows


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, cell=None, driver=None, clock=process_age) -> dict:
    """One run: the window, the metrics, the comparison.  ``cell`` and
    ``driver`` may be given (tests run a small configuration on the CPU,
    or a broken program)."""
    import torch

    from . import serve, spec as specs, train
    from .metrics import reader
    from .window import Window, reduce_trace

    bench = specs.benchmark()
    cell = cell or specs.cell(workload, bench)
    driver = driver or {"serve": serve, "train": train}[cell.kind]
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    win = Window(trace, cell.limits["kernels"])
    out = driver.run(cell, seed, seconds, win, device, clock)
    fed = fed_of(cell.kind, out, cell.traffic)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = {"spec": cell.spec, "fed": fed, "out": out, "peaks": specs.peaks()}
    if trace and win.prof is not None:
        dev, spans = win.events()
        run["trace"] = reduce_trace(dev, spans)
        win.prof = None
    metrics = {}
    for m in specs.metrics_of(cell.name, trace, bench):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checked = driver.check(cell, seed, out, device)
    print(f"portbench: setup {out['setup_s']:.2f} s, window {out['window_s']:.2f} s, "
          f"attempted {out['attempted']}, check {time.perf_counter() - t_check:.2f} s, "
          f"peak {peak / 2**30:.2f} GiB", file=sys.stderr)
    correct, rows = compare(cell, checked, win.counts, fed)
    correct = correct and out["failed"] == 0
    result = {"correct": bool(correct), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": torch.cuda.get_device_name(0) if on_card
                         else "cpu",
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if "trace" in run:
        result["device"]["busy_s"] = run["trace"]["busy_s"]
        result["device"]["window_s"] = out["window_s"]
        result["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                               "idle_gaps": run["trace"]["idle_gaps"]}
    result["checked"] = rows
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_env()
    from . import spec as specs
    cell = specs.cell(args.workload)

    import torch
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda"), cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, row in result["checked"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
