#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Usage, from the root of a checkout, on a machine with a CUDA card::

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

1. device — requires ``torch.cuda.is_available()``; prints the card's
   name and power limit as ``nvidia-smi`` reports them;
2. build — compiles every CUDA kernel of the port from the checkout's
   sources with ``nvcc`` (one process per source, started together);
3. kernels — holds each kernel against its plain PyTorch version on the
   card, bit for bit, at the serve path's shape and at a stress shape, and
   times both with CUDA events;
4. main path — the bigset serve flow on ``cuda`` through the port's
   public entry points (``BigsetCluster`` → ``BigsetService`` →
   ``BigsetClient``): 3 replicas, 100,000 eight-byte elements, 2,000
   context-less removes, a full paginated Scan, the backpressure demo, a
   membership → context-remove round trip and a Count, every answer held
   against a Python set; the kernel launch counts are zeroed just before
   and read just after;
5. parity — the same flow at 20,000 elements and 400 removes on ``cpu``
   (the plain versions) and on ``cuda`` must give identical pages.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.  The script imports
neither ``jax`` nor the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, as tabulated in the repo's measurement
# notes): HBM bandwidth, and the non-tensor 32-bit rate.  The int32
# compares of dot_seen issue on no more lanes than float32 does, so a bound
# taken against this rate is a lower bound on the card's time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

SET = b"smoke"
PATH_SHAPE = dict(n_actors=1, n_runs=2000, n_dots=1024)
STRESS_SHAPE = dict(n_actors=64, n_runs=4096, n_dots=1 << 20)


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def say(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ phases
def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    card = proc.stdout.strip().splitlines()[0]
    say(card)
    say(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    return card


def phase_build():
    from repro_torch.kernels import build
    from repro_torch.kernels.dot_seen import kernel as dot_seen_kernel

    sources = [dot_seen_kernel.SOURCE]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(build.load, sources))
    dot_seen_kernel.library()
    dt = time.perf_counter() - t0
    say(f"[build] {len(sources)} CUDA source(s) built for sm_90a in "
        f"{dt:.2f}s -> {build.build_dir()}")


def _canonical_runs(rng, n_actors, n_runs, hi, fill, np):
    """Disjoint sorted runs per row inside [1, hi], ``fill`` of the slots
    used, the rest the empty sentinel (1, 0)."""
    starts = np.ones((n_actors, n_runs), np.int64)
    ends = np.zeros((n_actors, n_runs), np.int64)
    used = max(1, int(n_runs * fill))
    for a in range(n_actors):
        edges = np.unique(rng.integers(1, hi + 1, 2 * used + 256,
                                       dtype=np.int64))
        edges = np.sort(rng.choice(edges, 2 * used, replace=False))
        starts[a, :used] = edges[0::2]
        ends[a, :used] = edges[1::2]
    return starts.astype(np.int32), ends.astype(np.int32)


def kernel_inputs(torch, np, shape: str, device: str = "cuda"):
    """Seeded inputs at one of the two shapes, on ``device``."""
    if shape == "path":
        # the serve path: one actor's tombstone of 2,000 single-dot runs
        # (every 50th of 100,000 elements removed), scanned 1,024 dots at a
        # time; padding dots carry the sentinel counter 0
        a, r, n = (PATH_SHAPE[k] for k in ("n_actors", "n_runs", "n_dots"))
        starts = np.arange(r, dtype=np.int32)[None, :] * 50 + 1
        ends = starts.copy()
        counters = np.arange(1, n + 1, dtype=np.int32) + 40_000
        counters[-24:] = 0
        actors = np.zeros(n, np.int32)
    else:
        # the stress shape: unsorted rows, counters up to 2^31 - 1, and
        # actors outside [0, A)
        rng = np.random.default_rng(11)
        a, r, n = (STRESS_SHAPE[k] for k in ("n_actors", "n_runs", "n_dots"))
        starts, ends = _canonical_runs(rng, a, r, 2**31 - 1, 0.9, np)
        perm = np.argsort(rng.random((a, r)), axis=1)
        starts = np.take_along_axis(starts, perm, axis=1)
        ends = np.take_along_axis(ends, perm, axis=1)
        actors = rng.integers(-3, a + 3, n).astype(np.int32)
        pick = rng.integers(0, r, n)
        row = np.clip(actors, 0, a - 1)
        edge = rng.integers(0, 5, n)
        base = np.where(edge < 2, starts[row, pick], ends[row, pick]).astype(np.int64)
        base += np.choose(edge, [-1, 0, 0, 1, 0])
        uniform = rng.integers(0, 2**31 - 1, n, dtype=np.int64)
        counters = np.where(rng.random(n) < 0.5, base, uniform)
        counters = np.clip(counters, 0, 2**31 - 1).astype(np.int32)
        counters[:4] = [2**31 - 1, 0, 1, 2**31 - 2]
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (starts, ends, actors, counters)]


CHUNK = 1 << 16


def plain_chunked(torch, ref, starts, ends, actors, counters):
    """The plain version over N in chunks: its [N, R] gather would not fit
    the card at the stress shape in one piece."""
    return torch.cat([
        ref(starts, ends, actors[lo:lo + CHUNK], counters[lo:lo + CHUNK])
        for lo in range(0, actors.shape[0], CHUNK)])


def runs_scanned(torch, starts, ends, actors, counters) -> int:
    """Runs the kernel walks for these inputs: up to each dot's first hit,
    all R on a miss, none for an actor outside [0, A)."""
    total = 0
    n_actors, r = starts.shape
    for lo in range(0, actors.shape[0], CHUNK):
        a = actors[lo:lo + CHUNK]
        c = counters[lo:lo + CHUNK]
        known = (a >= 0) & (a < n_actors)
        rows = torch.where(known, a, torch.zeros_like(a)).long()
        hit = (starts[rows] <= c[:, None]) & (c[:, None] <= ends[rows])
        first = torch.where(hit.any(dim=1), hit.int().argmax(dim=1) + 1,
                            torch.full_like(a, r))
        total += int(torch.where(known, first, torch.zeros_like(first)).sum())
    return total


def time_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(torch, fn, iters: int) -> float:
    """Device time of ``fn``'s launches alone: ``iters`` calls captured in
    one CUDA graph and replayed, so host launch cost is not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return time_ms(torch, g.replay, 5, warmup=1) / iters


def phase_kernels(torch, np):
    from repro_torch.core.vclock import DenseClock
    from repro_torch.kernels.dot_seen import dot_seen, dot_seen_ref
    from repro_torch.kernels.dot_seen.kernel import dot_seen_cuda

    results = {}
    for shape in ("path", "stress"):
        starts, ends, actors, counters = kernel_inputs(torch, np, shape)
        clock = DenseClock(starts, ends)
        got = dot_seen(clock, actors, counters)
        torch.cuda.synchronize()
        want = plain_chunked(torch, dot_seen_ref,
                             starts, ends, actors, counters)
        mismatches = int((got != want).sum())
        max_abs_err = int((got.int() - want.int()).abs().max())
        check(mismatches == 0,
              f"dot_seen at the {shape} shape: {mismatches} mismatches")
        a, r = starts.shape
        n = actors.shape[0]
        nbytes = 2 * a * r * 4 + n * 4 * 2 + n * 1
        # two compares per run walked, up to the first hit
        ops = 2 * runs_scanned(torch, starts, ends, actors, counters)
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        iters = 200 if shape == "path" else 5
        ms = time_ms(torch, lambda: dot_seen(clock, actors, counters), iters)
        device_ms = graph_ms(
            torch, lambda: dot_seen_cuda(starts, ends, actors, counters),
            iters)
        if shape == "path":
            plain_ms = time_ms(
                torch, lambda: dot_seen_ref(starts, ends, actors, counters),
                iters)
        else:
            plain_ms = time_ms(
                torch, lambda: plain_chunked(torch, dot_seen_ref, starts, ends,
                                             actors, counters), 1, warmup=1)
        res = dict(shape=f"A={a},R={r},N={n}", mismatches=mismatches,
                   max_abs_err=max_abs_err, ms=ms, device_ms=device_ms,
                   plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=nbytes, ops=ops,
                   seen=int(got.sum()))
        results[shape] = res
        say(f"[kernel] dot_seen {shape}: {json.dumps(res)}")
    return results


def drive(torch, device: str, n_elements: int, n_removes: int,
          page_size: int = 1000, timed: bool = False, demo: bool = False):
    """The serve flow on ``device``; returns the scan's pages as plain data.

    Every answer is held against a Python set of what was written."""
    from repro_torch.cluster import BigsetCluster
    from repro_torch.query.plan import Count, Scan
    from repro_torch.serve.bigset_service import (Backpressure, BigsetClient,
                                                  BigsetService, ServiceConfig)

    cluster = BigsetCluster(3, device=device)
    client = BigsetClient(BigsetService(cluster))
    elements = [b"%08d" % i for i in range(n_elements)]
    model = set(elements)
    tag = f"[main {device} {n_elements}]"

    t0 = time.perf_counter()
    for base in range(0, n_elements, 1000):
        res = client.batch(SET, [["add", e] for e in elements[base:base + 1000]])
        check(all("dot" in r for r in res), "an insert returned no dot")
    t_insert = time.perf_counter() - t0
    step = max(1, n_elements // n_removes)
    doomed = elements[::step][:n_removes]
    t0 = time.perf_counter()
    for base in range(0, len(doomed), 1000):
        res = client.batch(SET, [["remove", e] for e in doomed[base:base + 1000]])
        check(all(r.get("removed") for r in res), "a ctx-less remove missed")
    t_remove = time.perf_counter() - t0
    model.difference_update(doomed)
    tomb = cluster.vnodes[cluster.actors[0]].read_tombstone(SET)
    runs = sum(1 for _ in tomb.iter_runs())
    if timed:
        say(f"{tag} write: {n_elements} inserts in {t_insert:.3f}s "
            f"({n_elements / t_insert:.0f} el/s), {len(doomed)} ctx-less "
            f"removes in {t_remove:.3f}s; tombstone {runs} runs")

    t0 = time.perf_counter()
    pages, members = [], []
    for page in client.pages(Scan(SET, page_size=page_size)):
        members.extend(page.members)
        pages.append(([(e, tuple(tuple(d) for d in ds))
                       for e, ds in page.entries], dict(page.stats)))
    t_scan = time.perf_counter() - t0
    check(members == sorted(model),
          f"scan returned {len(members)} elements, the model holds {len(model)}")
    launches = sum(p[1]["kernel_launches"] for p in pages)
    if timed:
        say(f"{tag} scan: {len(members)} elements in {len(pages)} pages, "
            f"{t_scan:.3f}s ({len(members) / t_scan:.0f} el/s)")
        say(f"{tag} dot_seen launches per page: "
            f"{launches / len(pages):.2f} ({launches} over {len(pages)} pages)")

    if demo:
        retries = [0]

        def backoff(seconds: float) -> None:
            retries[0] += 1
            time.sleep(seconds)

        tight = BigsetClient(BigsetService(cluster, ServiceConfig(
            byte_budget=1, budget_window=0.5, lease_ttl=60.0)))
        slow = []
        for page in tight.pages(Scan(SET, page_size=page_size), sleep=backoff):
            slow.extend(page.members)
            if len(slow) >= 3 * page_size or page.cursor is None:
                break
        check(slow == sorted(model)[:len(slow)], "backpressured pages drifted")
        check(retries[0] > 0, "backpressure never engaged")
        say(f"{tag} backpressure: {len(slow)} elements, {retries[0]} retries, "
            f"no element re-emitted or skipped")

        def ride_out(fn, *args):
            while True:
                try:
                    return fn(*args)
                except Backpressure as bp:
                    time.sleep(bp.retry_after)

        victim = min(model)
        present, ctx = ride_out(client.membership, SET, victim)
        check(present and bool(ctx), "membership missed a live element")
        client.remove(SET, victim, ctx=ctx)
        model.discard(victim)
        present, _ = ride_out(client.membership, SET, victim)
        check(not present, "element visible after its ctx remove")
        gone, _ = ride_out(client.membership, SET, doomed[-1])
        check(not gone, "a removed element is visible")
        count = ride_out(client.query, Count(SET)).count
        check(count == len(model), f"count {count} != model {len(model)}")
        say(f"{tag} membership ctx round trip ok; count {count}")
    client.close()
    return pages


def phase_main(torch):
    from repro_torch.kernels.dot_seen import DISPATCHES

    DISPATCHES.reset()
    t0 = time.perf_counter()
    drive(torch, "cuda", 100_000, 2_000, timed=True, demo=True)
    torch.cuda.synchronize()
    launched = DISPATCHES.snapshot()
    say(f"[main] done in {time.perf_counter() - t0:.3f}s; dispatches "
        f"{json.dumps(vars(launched))}")
    check(launched.kernel_launches > 0, "the main path launched no kernel")
    check(launched.kernel_launches == launched.launches,
          "a dot_seen dispatch on the main path missed the CUDA kernel")
    return launched


def phase_parity(torch):
    cpu = drive(torch, "cpu", 20_000, 400)
    cuda = drive(torch, "cuda", 20_000, 400)
    check(len(cpu) == len(cuda), "cpu and cuda page counts differ")
    for i, (a, b) in enumerate(zip(cpu, cuda)):
        check(a == b, f"page {i} differs between cpu and cuda")
    say(f"[parity] cpu and cuda agree on {len(cpu)} pages at 20000 elements")


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    try:
        phase_device(torch)
        phase_build()
        kres = phase_kernels(torch, np)
        launched = phase_main(torch)
        phase_parity(torch)
        leaked = sorted(m for m in sys.modules
                        if m == "jax" or m.startswith("jax.")
                        or m == "repro" or m.startswith("repro."))
        check(not leaked, f"imported {leaked[:5]}")
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    path = kres["path"]
    kernels = [{
        "name": "dot_seen",
        "route": "cuda",
        "source": "src/repro_torch/kernels/dot_seen/csrc/dot_seen.cu",
        "replaces": "src/repro/kernels/dot_seen/kernel.py:53",
        "launches": launched.kernel_launches,
        "max_abs_err": max(r["max_abs_err"] for r in kres.values()),
        "ms": path["ms"],
        "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"],
        "library_ms": None,
        "device_ms": path["device_ms"],
        "shape": path["shape"],
    }]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
