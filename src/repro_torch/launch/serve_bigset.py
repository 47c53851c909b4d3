"""Bigset query-service launcher: the serve layer driven end to end.

Builds a :class:`BigsetCluster`, fronts it with :class:`BigsetService`, and
drives the full client lifecycle over the wire protocol: batch inserts,
a cursor-paginated scan with per-page IoStats, a deliberately small byte
budget so backpressure engages mid-scan (the client backs off and resumes
the same cursor), and a membership → remove causal-context round trip.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_bigset \\
      --elements 5000 --page-size 500 --replicas 3 [--device cpu]

Every stdout line is stable enough for CI to grep; the final line is
``serve_bigset demo ok``.

PyTorch port of :mod:`repro.launch.serve_bigset`, with ``--device``
(default ``cuda``): where the cluster's queries filter visibility.
"""
from __future__ import annotations

import argparse
import time

from ..cluster.clusters import BigsetCluster
from ..obs.export import write_chrome_trace
from ..obs.trace import Tracer
from ..query.plan import Count, Scan
from ..serve.bigset_service import (Backpressure, BigsetClient, BigsetService,
                                    ServiceConfig)

SET = b"demo"


def _expect(cond: bool, what: str) -> None:
    """Demo self-check that survives ``python -O`` (the CI smoke runs this
    launcher assert-stripped, so a bare assert would check nothing)."""
    if not cond:
        raise RuntimeError(f"serve_bigset demo failed: {what}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--elements", type=int, default=5000)
    ap.add_argument("--page-size", type=int, default=500)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--budget-window", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="where queries run the dot_seen filter: cuda "
                         "(the CUDA kernel) or cpu (the plain version)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable tracing and write a Chrome trace-event "
                         "file (load in chrome://tracing / Perfetto)")
    args = ap.parse_args(argv)

    tracer = Tracer() if args.trace_out else None
    cluster = BigsetCluster(args.replicas, tracer=tracer,
                            device=args.device)
    service = BigsetService(cluster)  # default config: generous budget
    client = BigsetClient(service)

    # ---- write path: batch inserts through the wire protocol -------------
    t0 = time.perf_counter()
    for base in range(0, args.elements, 1000):
        ops = [["add", b"%08d" % i]
               for i in range(base, min(base + 1000, args.elements))]
        client.batch(SET, ops)
    dt = time.perf_counter() - t0
    print(f"inserted {args.elements} elements in {dt:.2f}s "
          f"({args.elements / dt:.0f} el/s over the wire)")

    # ---- paginated scan: O(page) bytes per request -----------------------
    seen = 0
    n_pages = 0
    t0 = time.perf_counter()
    for page in client.pages(Scan(SET, page_size=args.page_size)):
        seen += len(page.entries)
        n_pages += 1
        if n_pages <= 3 or page.cursor is None:
            print(f"  page {n_pages}: {len(page.entries)} elements, "
                  f"{page.stats['bytes_read']}B read, "
                  f"{page.stats['num_seeks']} seeks")
    dt = time.perf_counter() - t0
    _expect(seen == args.elements,
            f"scan saw {seen} of {args.elements} elements")
    print(f"scanned {seen} elements in {n_pages} pages / {dt:.2f}s")

    # ---- saturation: an over-budget client is rejected, then resumes -----
    # byte_budget=1 makes every page overspend its window: page N+1 is
    # rejected until the window rolls, deterministically — the demo shows
    # the rejection AND that the cursor survives it.
    retries = [0]

    def backoff(seconds: float) -> None:
        retries[0] += 1
        print(f"backpressure engaged: retrying in {seconds:.3f}s "
              f"(cursor preserved)")
        time.sleep(seconds)

    tight = BigsetClient(BigsetService(cluster, ServiceConfig(
        byte_budget=1, budget_window=args.budget_window, lease_ttl=60.0)))
    slow = []
    for page in tight.pages(Scan(SET, page_size=args.page_size),
                            sleep=backoff):
        slow.extend(page.members)
        if len(slow) >= 3 * args.page_size or page.cursor is None:
            break  # three pages prove the reject→resume cycle
    _expect(slow == [b"%08d" % i for i in range(len(slow))], "pages drifted")
    _expect(retries[0] > 0, "saturation demo never engaged backpressure")
    print(f"saturated scan: {len(slow)} elements under a 1-byte/"
          f"{args.budget_window:g}s budget, {retries[0]} retries, "
          f"no element re-emitted or skipped")

    # ---- causal-context round trip ---------------------------------------
    def ride_out(fn, *fn_args, **fn_kw):
        """Point queries share the budget with the scan: back off the same way."""
        while True:
            try:
                return fn(*fn_args, **fn_kw)
            except Backpressure as bp:
                backoff(bp.retry_after)

    present, ctx = ride_out(client.membership, SET, b"%08d" % 0)
    _expect(present and bool(ctx), "inserted element not found by membership")
    client.remove(SET, b"%08d" % 0, ctx=ctx)
    present, _ = ride_out(client.membership, SET, b"%08d" % 0)
    _expect(not present, "element still visible after ctx remove")
    count = ride_out(client.query, Count(SET)).count
    _expect(count == args.elements - 1,
            f"count {count} != {args.elements - 1} after one remove")
    print(f"membership ctx round-trip remove ok; count now {count}")

    client.close()
    if tracer is not None:
        write_chrome_trace(tracer.spans, args.trace_out)
        print(f"wrote {len(tracer.spans)} spans -> {args.trace_out}")
    print("serve_bigset demo ok")


if __name__ == "__main__":
    main()
