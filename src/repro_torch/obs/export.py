"""Span exporters: JSONL dumps and Chrome trace-event files.

Two formats, one source (:attr:`repro.obs.trace.Tracer.spans`):

* **JSONL** — one span per line, machine-greppable, append-friendly; the
  format CI artifacts and offline analysis consume.
* **Chrome trace-event** — ``{"traceEvents": [...]}`` of complete
  (``"ph": "X"``) events, loadable in ``chrome://tracing`` / Perfetto for
  flamegraph viewing.  Each event carries ``span_id`` / ``parent_id`` /
  ``trace_id`` in ``args`` so the span *tree* round-trips through the
  format, not just the timings — the CI smoke job re-parses an exported
  file and checks every parent resolves.

PyTorch port: a copy of :mod:`repro.obs.export`; everything below
this docstring is unchanged.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from .trace import Span


def span_to_dict(span: Span) -> dict:
    return {
        "name": span.name,
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "parent_id": span.parent_id,
        "start": span.start,
        "end": span.end,
        "attrs": {k: _jsonable(v) for k, v in span.attrs.items()},
    }


def _jsonable(v):
    """Span attrs may hold bytes (set names, elements): make them JSON-safe."""
    if isinstance(v, bytes):
        return v.decode("utf-8", "backslashreplace")
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


# --------------------------------------------------------------------- jsonl
def spans_to_jsonl(spans: Iterable[Span]) -> str:
    return "".join(json.dumps(span_to_dict(s), sort_keys=True) + "\n"
                   for s in spans)


def write_jsonl(spans: Iterable[Span], path: str) -> None:
    with open(path, "w") as f:
        f.write(spans_to_jsonl(spans))


# -------------------------------------------------------------- chrome trace
def spans_to_chrome(spans: Iterable[Span]) -> dict:
    """Complete ("X") trace events; ts/dur in microseconds per the spec.

    ``pid`` is constant (one process), ``tid`` is the trace id — so each
    request's tree renders as its own track in the viewer.
    """
    events: List[dict] = []
    for s in spans:
        events.append({
            "name": s.name,
            "cat": s.name.split(".", 1)[0],
            "ph": "X",
            "ts": s.start * 1e6,
            "dur": s.duration * 1e6,
            "pid": 1,
            "tid": s.trace_id,
            "args": {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                **{k: _jsonable(v) for k, v in s.attrs.items()},
            },
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: Iterable[Span], path: str) -> None:
    with open(path, "w") as f:
        json.dump(spans_to_chrome(spans), f)


# ----------------------------------------------------------------- tree view
def span_trees(spans: Iterable[Span]) -> Dict[int, dict]:
    """Group spans into ``{trace_id: {"roots": [...], "children": {...},
    "orphans": [...]}}``.

    A span whose ``parent_id`` is missing from its trace is an **orphan**
    — under lossy delivery that means a *dropped* parent, which the
    explicit-context design makes impossible (children are parented on
    the sender's still-local span, never on an in-flight one), so tests
    assert ``orphans == []``.
    """
    by_trace: Dict[int, List[Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    out: Dict[int, dict] = {}
    for trace_id, group in by_trace.items():
        ids = {s.span_id for s in group}
        children: Dict[int, List[Span]] = {}
        roots, orphans = [], []
        for s in group:
            if s.parent_id is None:
                roots.append(s)
            elif s.parent_id in ids:
                children.setdefault(s.parent_id, []).append(s)
            else:
                orphans.append(s)
        out[trace_id] = {"roots": roots, "children": children,
                         "orphans": orphans}
    return out


def tree_names(spans: Iterable[Span], trace_id: Optional[int] = None
               ) -> Dict[str, int]:
    """``{span name: count}`` for one trace (default: the only trace) —
    the coverage check tests and CI run against an exported tree."""
    trees = span_trees(spans)
    if trace_id is None:
        if len(trees) != 1:
            raise ValueError(f"expected one trace, found {sorted(trees)}")
        trace_id = next(iter(trees))
    names: Dict[str, int] = {}
    tree = trees[trace_id]
    stack = list(tree["roots"])
    while stack:
        s = stack.pop()
        names[s.name] = names.get(s.name, 0) + 1
        stack.extend(tree["children"].get(s.span_id, ()))
    return names
