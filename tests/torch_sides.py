"""Both packages behind one face, for the port's parity tests.

A ported case is written once as a function of a *side* ``P`` — the JAX
package or the port, each exposing the names the reference's tests import
(``P.BigsetCluster``, ``P.Range``, ``P.sync``, ...).  :func:`both` runs it
on each side with the same arguments, and holds the two answers equal
after :func:`plain` has turned them into package-free data (a port
``Clock`` and a JAX ``Clock`` are different classes; their runs are not).
The port's entry points that take a ``device`` run on the CPU.
"""
import dataclasses
import functools
import hashlib
import importlib

import numpy as np
import torch

import repro.core  # noqa: F401  (core before index: ROADMAP C2)
import repro_torch.core  # noqa: F401

# where a side looks a name up, in order (the reference tests' imports)
_MODULES = (
    "query", "query.plan", "query.planner", "query.batch", "core.bigset",
    "core.clock", "core.dots", "index", "index.spec", "cluster.clusters",
    "cluster.placement", "cluster.sim", "cluster.antientropy", "storage",
    "storage.wal", "storage.lsm", "serve.bigset_service", "obs.trace",
)
# entry points of the port that take a device
_ON_DEVICE = {"BigsetCluster": "cluster.clusters",
              "QueryExecutor": "query.executor",
              "BatchVisibility": "query.batch"}


class Side:
    """One package's names, as ``P.<name>``; ``device`` binds the port's
    entry points (``None`` for the JAX package, which takes none)."""

    def __init__(self, root: str, device=None):
        self.root = root
        self.device = device
        self._mods = [importlib.import_module(f"{root}.{m}") for m in _MODULES]

    def mod(self, name: str):
        return importlib.import_module(f"{self.root}.{name}")

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in _ON_DEVICE:
            cls = getattr(self.mod(_ON_DEVICE[name]), name)
            value = (functools.partial(cls, device=self.device)
                     if self.device is not None else cls)
        else:
            for m in self._mods:
                if hasattr(m, name):
                    value = getattr(m, name)
                    break
            else:
                raise AttributeError(f"{self.root} has no {name!r}")
        setattr(self, name, value)
        return value

    def __repr__(self) -> str:
        return self.root


JAX = Side("repro")
PORT = Side("repro_torch", device="cpu")


def plain(x):
    """``x`` as package-free data: dataclasses by field, clocks by runs,
    sets as frozensets, arrays and tensors as lists."""
    if x is None or isinstance(x, (bool, int, float, str, bytes)):
        return x
    if isinstance(x, bytearray):
        return bytes(x)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (set, frozenset)):
        return frozenset(plain(v) for v in x)
    if isinstance(x, tuple):
        return tuple(plain(v) for v in x)
    if isinstance(x, list):
        return [plain(v) for v in x]
    if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
        return ("array", np.asarray(x).tolist())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, plain(getattr(x, f.name))) for f in dataclasses.fields(x))
    kind = type(x).__name__
    if kind == "Clock":
        return ("Clock", plain(x.iter_runs()))
    if kind == "Orswot":
        return ("Orswot", plain(x.clock), plain(dict(x.entries)))
    if isinstance(x, BaseException):
        return (kind, str(x))
    raise TypeError(f"no plain form for {kind}")


def both(fn, *args, **kwargs):
    """``fn(side, *args)`` on the JAX package and on the port; their
    answers must be equal.  Returns the port's."""
    want = fn(JAX, *args, **kwargs)
    got = fn(PORT, *args, **kwargs)
    assert plain(got) == plain(want)
    return got


def store_digest(store) -> str:
    """One hash of a store's live (key, value) pairs, in key order."""
    h = hashlib.sha256()
    for k, v in store.scan():
        h.update(len(k).to_bytes(4, "big") + k + len(v).to_bytes(4, "big") + v)
    return h.hexdigest()


def cluster_state(c):
    """What a cluster shows of itself: the network's traffic, the
    anti-entropy ledger, the ring, and every live vnode's store."""
    return {
        "net": (c.net.bytes_sent, c.net.msgs_sent, c.net.msgs_dropped,
                c.net.pending()),
        "ae": c.ae_stats(),
        "ring": c.ring_state(),
        "crashed": sorted(c.crashed),
        "stores": {a: store_digest(vn.store) for a, vn in c.vnodes.items()},
    }
