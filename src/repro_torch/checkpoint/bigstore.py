"""BigStore — decomposed delta checkpointing over bigset CRDTs.

This is the paper's technique applied to the framework's durability plane
(DESIGN.md §2 mapping table).  A monolithic checkpoint is Riak's
riak-object: every save serializes the whole train-state blob — O(n) per
save, O(n²) over a run.  BigStore decomposes the train state the way
bigset decomposes a Set:

* **element**  = one state shard, named ``<param-path>/<slice>``;
* **insert**   = saving a shard: a fresh dot + the shard bytes as the
  element value, written with the *previous* save's dots as the op context
  — the paper's add-supersedes-add rule (§footnote 1) automatically
  tombstones the stale shard so storage compaction (§4.3.3) reclaims it;
* **delta replication** = each host durably writes only *its own* slice of
  the state plus causal metadata, then ships the element-keys to R-1 peer
  stores (Algorithm 2 apply: dot-seen check + append — no read-modify-write
  of a checkpoint blob anywhere);
* **restore**  = a quorum streaming fold (§4.4): any R surviving stores
  merge with the streaming ORSWOT join; per-shard concurrent versions
  resolve by highest step.  A checkpoint is usable iff the merged set
  covers every expected shard — torn/partial saves are safe by
  construction (the old shard version survives until superseded).

Delta saves skip shards whose content hash is unchanged (MoE cold experts,
frozen embeddings): the old element simply stays live — this is where the
O(Δ) vs O(n) gap shows up in benchmarks/bench_checkpoint.py.

PyTorch port of :mod:`repro.checkpoint.bigstore`: a copy over the port's
own ``core``, except the shard codec.  A shard is a CPU tensor (or a numpy
array); :func:`_pack_shard` writes the same bytes as the JAX package's for
the same values and step, a bf16 tensor as its ``uint16`` bit pattern
tagged ``"bfloat16"`` (``str`` of JAX's ``bfloat16`` dtype), and
:func:`_unpack_shard` gives a CPU tensor back, reinterpreting a bf16
shard's ``uint16`` buffer as ``torch.bfloat16`` where JAX reaches
``jax.numpy`` for the type.
"""
from __future__ import annotations

import zlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import warnings

import msgpack
import numpy as np
import torch

from ..core.bigset import BigsetVnode, InsertDelta
from ..core.clock import Clock
from ..core.dots import Dot
from ..core.streaming import streaming_join


def _shard_bytes(arr) -> Tuple[str, List[int], bytes]:
    """(dtype name, shape, raw bytes) of a tensor or an array; a bf16
    tensor's bytes are its bits, named ``"bfloat16"``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), t.view(torch.int16).numpy(
                ).tobytes()
        arr = t.numpy()
    arr = np.asarray(arr)
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def _pack(step: int, dtype: str, shape: List[int], data: bytes) -> bytes:
    return msgpack.packb({
        "step": step,
        "dtype": dtype,
        "shape": shape,
        "data": data,
    })


def _pack_shard(step: int, arr) -> bytes:
    return _pack(step, *_shard_bytes(arr))


def _unpack_shard(raw: bytes) -> Tuple[int, torch.Tensor]:
    """(step, CPU tensor).  The tensor reads the unpacked buffer in place:
    it is the caller's to copy (``unflatten_state`` copies it)."""
    o = msgpack.unpackb(raw, strict_map_key=False)
    dt = o["dtype"]
    bits = np.frombuffer(o["data"], np.int16 if dt == "bfloat16"
                         else np.dtype(dt))
    with warnings.catch_warnings():  # torch warns of the read-only buffer
        warnings.simplefilter("ignore", UserWarning)
        arr = torch.from_numpy(bits)
    if dt == "bfloat16":
        arr = arr.view(torch.bfloat16)
    return o["step"], arr.reshape(o["shape"])


class BigStoreHost:
    """One host's durable checkpoint replica (a bigset vnode + helpers)."""

    def __init__(self, host_id: str):
        self.host_id = host_id
        self.vnode = BigsetVnode(host_id)
        self._last_hash: Dict[Tuple[bytes, bytes], int] = {}
        self.alive = True

    # ------------------------------------------------------------------ save
    def save_shard(self, run: bytes, name: bytes, step: int,
                   arr, *, delta_only: bool = True
                   ) -> Optional[InsertDelta]:
        """Insert one shard; returns the replication delta (None if skipped
        because the content is unchanged — the delta-checkpoint fast path)."""
        dtype, shape, data = _shard_bytes(arr)
        h = zlib.crc32(data)
        key = (run, name)
        if delta_only and self._last_hash.get(key) == h:
            return None
        self._last_hash[key] = h
        _, ctx = self.vnode.is_member(run, name)   # supersede previous save
        delta = self.vnode.coordinate_insert(
            run, name, ctx, value=_pack(step, dtype, shape, data))
        return delta

    def apply(self, delta: InsertDelta) -> bool:
        return self.vnode.replica_insert(delta)

    def compact(self):
        return self.vnode.compact()

    # ----------------------------------------------------------------- reads
    def stream(self, run: bytes):
        rs_clock = self.vnode.read_clock(run)
        entries = []
        values: Dict[Tuple[bytes, Dot], bytes] = {}
        cur: Optional[bytes] = None
        dots: List[Dot] = []
        for el, dot, val in self.vnode.fold_values(run):
            values[(el, dot)] = val
            if el != cur:
                if cur is not None:
                    entries.append((cur, tuple(dots)))
                cur, dots = el, [dot]
            else:
                dots.append(dot)
        if cur is not None:
            entries.append((cur, tuple(dots)))
        return rs_clock, entries, values


class BigStore:
    """Replicated checkpoint store across N hosts (replication factor R)."""

    def __init__(self, n_hosts: int, replication: int = 3):
        self.hosts = [BigStoreHost(f"ckpt-host{i}") for i in range(n_hosts)]
        self.r = min(replication, n_hosts)

    def replicas_for(self, shard_name: bytes, owner: int) -> List[int]:
        """Preference list: owner + next R-1 alive hosts (ring order)."""
        n = len(self.hosts)
        out = []
        i = owner
        while len(out) < self.r and len(out) < n:
            if self.hosts[i % n].alive:
                out.append(i % n)
            i += 1
            if i - owner > 2 * n:
                break
        return out

    def owner_of(self, shard_name: bytes) -> int:
        return zlib.crc32(shard_name) % len(self.hosts)

    # ------------------------------------------------------------------ save
    def save(self, run: bytes, shards: Dict[str, torch.Tensor], step: int,
             *, delta_only: bool = True) -> Dict[str, int]:
        """Save a shard-dict.  Each shard is coordinated by its owner host
        and delta-replicated to R-1 peers.  Returns {written|skipped: n}."""
        stats = {"written": 0, "skipped": 0, "bytes": 0}
        for name, arr in shards.items():
            bname = name.encode()
            prefs = self.replicas_for(bname, self.owner_of(bname))
            if not prefs:
                raise RuntimeError("no alive replicas")
            coord = self.hosts[prefs[0]]
            delta = coord.save_shard(run, bname, step, arr,
                                     delta_only=delta_only)
            if delta is None:
                stats["skipped"] += 1
                continue
            stats["written"] += 1
            stats["bytes"] += delta.size_bytes()
            for i in prefs[1:]:
                self.hosts[i].apply(delta)
        return stats

    # --------------------------------------------------------------- restore
    def restore(self, run: bytes, *, expect: Optional[Iterable[str]] = None
                ) -> Dict[str, Tuple[int, torch.Tensor]]:
        """Quorum streaming restore from all alive hosts."""
        alive = [h for h in self.hosts if h.alive]
        if not alive:
            raise RuntimeError("no alive checkpoint hosts")
        streams = []
        value_maps = []
        for h in alive:
            clock, entries, values = h.stream(run)
            streams.append((clock, entries))
            value_maps.append(values)

        out: Dict[str, Tuple[int, torch.Tensor]] = {}
        for element, dots in streaming_join(streams):
            best: Optional[Tuple[int, torch.Tensor]] = None
            for dot in dots:
                raw = None
                for vm in value_maps:
                    raw = vm.get((element, dot))
                    if raw is not None:
                        break
                if raw is None:
                    continue
                step, arr = _unpack_shard(raw)
                if best is None or step > best[0] or (
                        step == best[0] and dot > getattr(best, "dot", dots[0])):
                    best = (step, arr)
            if best is not None:
                out[element.decode()] = best
        if expect is not None:
            missing = set(expect) - set(out)
            if missing:
                raise RuntimeError(
                    f"checkpoint incomplete: {len(missing)} shards missing "
                    f"(e.g. {sorted(missing)[:3]})")
        return out

    # ------------------------------------------------------------------- ops
    def kill(self, idx: int) -> None:
        self.hosts[idx].alive = False

    def revive(self, idx: int) -> None:
        """Node replacement: fresh store learns via anti-entropy."""
        from ..cluster.antientropy import sync
        self.hosts[idx] = BigStoreHost(f"ckpt-host{idx}")
        donors = [h for i, h in enumerate(self.hosts) if h.alive and i != idx]
        if donors:
            runs = self._known_runs(donors[0])
            for run in runs:
                sync(self.hosts[idx].vnode, donors[0].vnode, run)

    def _known_runs(self, host: BigStoreHost) -> List[bytes]:
        runs = set()
        for k, _ in host.vnode.store.scan(b"", b"\xff" * 12):
            from ..storage.keycodec import decode_key
            parts = decode_key(k)
            runs.add(parts[0])
        return sorted(runs)

    def compact_all(self) -> None:
        for h in self.hosts:
            if h.alive:
                h.compact()

    def total_bytes(self) -> int:
        return sum(h.vnode.store.approximate_bytes()
                   for h in self.hosts if h.alive)

    def io_stats(self):
        from ..storage.lsm import IoStats
        agg = IoStats()
        for h in self.hosts:
            for k in vars(agg):
                setattr(agg, k, getattr(agg, k) + getattr(h.vnode.store.stats, k))
        return agg
