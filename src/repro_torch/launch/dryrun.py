"""Multi-pod dry run: trace every (arch × shape × mesh) cell on ``meta``
tensors over a faked world of 256 or 512 ranks.

PyTorch port of :mod:`repro.launch.dryrun`.  For each cell this shows,
without hardware:
  * the sharding config is coherent (the step runs on DTensors placed by
    the rules, and every collective DTensor needs is recorded),
  * what it holds (argument, output and tracked peak bytes per device),
  * and its roofline terms (FLOPs and bytes per device, collective bytes
    priced by the JAX package's ring model).

Where the JAX package forces 512 host devices and lowers with GSPMD, the
port makes a ``"fake"`` process group (``torch.testing._internal``: an
internal API, imported only inside :func:`fake_world`) of the mesh's
size, builds the model's parameters, optimizer state and cache on
``meta`` (shapes only), distributes them as DTensors by the rules, and
runs ``train_step`` / ``prefill_step`` / ``decode_step`` once under
:class:`Census`, a dispatch mode that lets DTensor desugar each op and
then sees each rank-local op: its FLOPs (``torch.utils.flop_counter``'s
formulas on local shapes), its operand bytes, every collective with its
group, and the bytes alive.  The kernels (B4, B5, B6 and the backwards)
compute nothing on ``meta``: their wrappers add their FLOPs and bytes to
:data:`~repro_torch.kernels.ledger.DRYRUN`, which the census adds in.
Nothing here is measured on hardware: a record is a prediction.

Where DTensor differs from GSPMD:
  * DTensor picks collectives op by op (``constrain`` redistributes then
    and there), where GSPMD propagates shardings through the whole step,
    so the collective census differs from the JAX package's;
  * ops with no DTensor strategy run on each rank's shard through
    ``local_map`` or an explicit redistribute: the attention kernels
    (``sharding.attention_map``: q by heads, k / v by KV heads, a
    ``kv_seq``-sharded cache gathered whole), the selective scan
    (``sharding.local_kernel``: rows and channels, the sequence gathered
    whole), the MoE routing's sort, top-k, searchsorted, gathers and
    scatters (``mlp._route_sharded``: rows, the router gathered) and its
    row permutations (``mlp.permute_rows``), and decode's cache write
    (``attention._write_slot``, on each rank's cache shard); each
    redistribute they take is in the census.
  * No scan correction: the port runs its layers in a Python loop, so
    every layer is traced and counted, and ``scan_corrected`` is false
    (the JAX package's ``corrected_costs`` differences two unrolled
    depths because XLA counts a scanned body once).
  * No XLA buffer assignment: ``memory`` holds the local bytes of the
    arguments (params, optimizer state, batch, cache), of the outputs that
    are new storage (``output_bytes``) and of those that reuse an
    argument's (``alias_bytes``: the in-place train step and decode
    cache), and the tracked peak; ``temp_bytes`` is the peak less the
    arguments, and ``t_memory`` prices argument + output + 2 × temp as
    the JAX package does.

Artifacts land in ``dryrun_torch/<arch>__<shape>__<mesh>.json`` at the
repository root (resumable; not the JAX package's folder).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] [--force]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
import weakref
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, get_config, input_specs
from ..configs.shapes import SHAPES, ShapeSpec, cell_applicable
from ..kernels.ledger import DRYRUN
from ..models import TrainState, build_model
from ..models.sharding import (P, distribute, guard, make_rules, mesh_axes,
                               placements, sharding_rules, tree_pspecs)
from ..tree import leaves, map_tree_with_path
from ..train.optimizer import opt_state_pspecs
from .mesh import HW, make_production_mesh

ART_DIR = Path(__file__).resolve().parents[3] / "dryrun_torch"


def ring_moved_bytes(op: str, result_bytes: float, n: int) -> float:
    """Per-device bytes a ring moves for one collective over ``n`` ranks
    whose result is ``result_bytes`` (the JAX package's model; ``op`` in
    its HLO names)."""
    if op == "all-reduce":
        return 2 * result_bytes * (n - 1) / max(n, 1)
    if op == "all-gather":
        return result_bytes * (n - 1) / max(n, 1)   # result = gathered
    if op == "reduce-scatter":
        return result_bytes * (n - 1)               # result = scattered
    if op == "all-to-all":
        return result_bytes * (n - 1) / max(n, 1)
    return result_bytes                              # collective-permute


def _group_size(group_name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


def _collectives():
    """``{op packet: (HLO name, group size of (args))}`` of the functional
    collectives DTensor issues."""
    f = torch.ops._c10d_functional
    return {
        f.all_gather_into_tensor: ("all-gather", lambda a: a[1]),
        f.reduce_scatter_tensor: ("reduce-scatter", lambda a: a[2]),
        f.all_reduce: ("all-reduce", lambda a: _group_size(a[2])),
        f.all_to_all_single: ("all-to-all", lambda a: _group_size(a[3])),
        torch.ops._dtensor.shard_dim_alltoall: (
            "all-to-all", lambda a: _group_size(a[3])),
    }


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Census(TorchDispatchMode):
    """Per-device FLOPs, operand bytes, collectives and live bytes of the
    rank-local ops a step runs.  A DTensor op is handed back to DTensor
    (``NotImplemented``), whose local ops and collectives then come
    through here, as ``CommDebugMode`` sees them.  ``FlopCounterMode``
    alone would see the DTensor ops at their global shapes (a count of
    the whole mesh's work, replicated work once); the census applies its
    formulas to the local shapes instead."""

    def __init__(self, arguments=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.flop_registry = flop_registry
        self.colls = _collectives()
        self.flops = 0
        self.bytes = 0
        self.collectives: List[Dict[str, Any]] = []
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        self.argument_keys = set()
        for t in arguments:
            self._track(t)
            self.argument_keys.add(t.untyped_storage()._cdata)
        self.argument_bytes = self.live

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):

        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        outs = [o for o in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in outs):
            return out  # DTensor's sharding propagation on global shapes
        if packet in self.flop_registry:
            self.flops += int(self.flop_registry[packet](*args, **kwargs,
                                                         out_val=out))
        if packet in self.colls:
            op, group = self.colls[packet]
            n = int(group(args))
            size = _nbytes(outs[0])
            self.collectives.append({
                "op": op, "result_bytes": size, "group": n,
                "moved_bytes": ring_moved_bytes(op, size, n)})
        if not func.is_view:
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for o in outs:
            self._track(o)
        return out


# ---------------------------------------------------------------- the rules
def cell_rules(mesh, shape_name: str):
    """Logical→physical bindings per shape cell (DESIGN.md §5)."""
    if shape_name == "long_500k":
        return make_rules(mesh, batch=None, kv_seq=("data",),
                          kv_heads="model")
    if shape_name.startswith("decode"):
        return make_rules(mesh, kv_seq="model")
    return make_rules(mesh)


def ep_rules(shape_name: str):
    """Expert-parallel variant: experts over the model axis (the §Perf
    hillclimb for MoE cells whose expert count divides the axis)."""
    def build(mesh):
        base = cell_rules(mesh, shape_name)
        over = dict(base.rules)
        over["experts"] = "model"
        over["moe_cap"] = None
        return make_rules(mesh, **over)
    return build


CACHE_RULES = {
    "k": ("batch", "kv_heads", "kv_seq", None),
    "v": ("batch", "kv_heads", "kv_seq", None),
    "k_scale": ("batch", "kv_heads", "kv_seq", None),
    "v_scale": ("batch", "kv_heads", "kv_seq", None),
    "conv": ("batch", None, "ff"),
    "h": ("batch", "ff", None),
    "enc_out": ("batch", None, None),
}


def cache_pspecs(cache, rules):
    def visit(path, leaf):
        logical = CACHE_RULES.get(str(path[-1]))
        if logical is None:
            return P()
        spec = ([None] * (leaf.dim() - len(logical))
                + [rules.axis(l) for l in logical])
        # a mesh axis shards at most one dim; non-divisible dims replicate
        return guard(tuple(leaf.shape)[-len(spec):], spec, rules)

    return map_tree_with_path(visit, cache)


def batch_pspecs(batch, rules):
    def visit(_, leaf):
        spec = rules.spec(*(["batch"] + [None] * (leaf.dim() - 1)))
        # guard divisibility (e.g. global_batch 1)
        out = []
        for dim, a in zip(leaf.shape, spec):
            if a is not None and dim % rules.mesh_axis_size(a) != 0:
                a = None
            out.append(a)
        return P(*out)

    return map_tree_with_path(visit, batch)


def logits_pspec(cfg, shape, rules):
    """(batch, vocab) spec with divisibility fallbacks."""
    b_ax = rules.axis("batch")
    if b_ax is not None and shape.global_batch % rules.mesh_axis_size(b_ax) != 0:
        b_ax = None
    v_ax = rules.axis("vocab")
    if v_ax is not None and cfg.vocab_size % rules.mesh_axis_size(v_ax) != 0:
        v_ax = None
    return P(b_ax, v_ax)


# ----------------------------------------------------------------- the trace
@contextmanager
def fake_world(n: int):
    """A ``"fake"`` process group of ``n`` ranks (this process rank 0) for
    the life of the block, unless one of ``n`` ranks exists already."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks exists; "
                f"the dry run needs {n}")
        yield
        return
    # internal API: the fake backend runs no collective, so shapes alone
    # flow through DTensor's redistributions
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _own(tree):
    """Each DTensor leaf of a meta tree with a storage of its own (a meta
    shard is a view of the whole), so live bytes count shards."""

    def own(_, t):
        if not isinstance(t, DTensor):
            return t
        return DTensor.from_local(t.to_local().clone(), t.device_mesh,
                                  t.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return map_tree_with_path(own, tree)


def _locals(tree) -> List[torch.Tensor]:
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in leaves(tree) if isinstance(t, torch.Tensor)]


def shard_bytes(tree, specs, mesh) -> int:
    """Local bytes a rank holds of ``tree`` placed by ``specs``, from the
    shapes and the mesh alone."""
    sizes = mesh_axes(mesh)
    total = 0
    for t, s in zip(leaves(tree), leaves(specs)):
        split = 1
        for a in s:
            for name in (a if isinstance(a, tuple) else (a,) if a else ()):
                split *= sizes[name]
        total += _nbytes(t) // split
    return total


def cell_args(model, shape: ShapeSpec, rules):
    """A cell's step arguments on ``meta`` and their specs: ``(state,
    batch)`` for train, ``(params, batch)`` for prefill, ``(params,
    cache, batch)`` for decode."""
    batch = input_specs(model.cfg, shape)
    b_specs = batch_pspecs(batch, rules)
    if shape.kind == "train":
        state = model.init_train_state(0)
        p_specs = tree_pspecs(state.params, rules)
        specs = TrainState(p_specs, opt_state_pspecs(state.opt, p_specs), P())
        return (state, batch), (specs, b_specs)
    params = model.init(0)
    p_specs = tree_pspecs(params, rules)
    if shape.kind == "prefill":
        return (params, batch), (p_specs, b_specs)
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    return (params, cache, batch), (p_specs, cache_pspecs(cache, rules),
                                    b_specs)


def trace_cell(cfg, shape: ShapeSpec, mesh, rules) -> Dict[str, Any]:
    """Run one step of one cell on meta DTensors under :class:`Census`.
    Returns the census' counts and the argument bytes by the rules."""
    model = build_model(cfg, "meta")
    args, arg_specs = cell_args(model, shape, rules)
    by_rules = shard_bytes(args, arg_specs, mesh)
    dargs = _own(distribute(args, arg_specs, mesh))
    logits_pl = placements(logits_pspec(cfg, shape, rules), mesh)

    DRYRUN.reset()
    t0 = time.time()
    with sharding_rules(rules), implicit_replication(), \
            Census(_locals(dargs)) as census:
        if shape.kind == "train":
            state, b = dargs
            out = model.train_step(state, b)
        elif shape.kind == "prefill":
            params, b = dargs
            logits, new_cache = model.prefill_step(params, b,
                                                   max_len=shape.seq_len)
            # the JAX package's out_shardings: logits and cache by the rules
            c_specs = cache_pspecs(new_cache, rules)
            new_cache = map_tree_with_path(
                lambda _, t, s: t.redistribute(mesh, placements(s, mesh)),
                new_cache, c_specs)
            out = (logits.redistribute(mesh, logits_pl), new_cache)
        else:
            params, cache, b = dargs
            logits, new_cache = model.decode_step(params, cache, b["tokens"],
                                                  b["cache_len"])
            out = (logits.redistribute(mesh, logits_pl), new_cache)
        outs = _locals(out)
        aliased = [t for t in outs
                   if t.untyped_storage()._cdata in census.argument_keys]
        fresh = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                 for t in outs
                 if t.untyped_storage()._cdata not in census.argument_keys}
        seconds = time.time() - t0
    return {
        "seconds": seconds,
        "argument_bytes": census.argument_bytes,
        "argument_bytes_by_rules": by_rules,
        "output_bytes": sum(fresh.values()),
        "alias_bytes": sum(_nbytes(t) for t in aliased),
        "peak_bytes": census.peak,
        "flops": census.flops + DRYRUN.flops,
        "kernel_flops": DRYRUN.flops,
        "kernel_calls": DRYRUN.calls,
        "bytes": census.bytes + DRYRUN.bytes,
        "collectives": census.collectives,
    }


def cell_record(arch: str, shape: ShapeSpec, mesh_kind: str, n_chips: int,
                cfg, m: Dict[str, Any]) -> dict:
    """The JAX package's record of one cell, from :func:`trace_cell`'s
    counts."""
    moved = sum(c["moved_bytes"] for c in m["collectives"])
    by_op: Dict[str, list] = {}
    for c in m["collectives"]:
        by_op.setdefault(c["op"], [0, 0.0])
        by_op[c["op"]][0] += 1
        by_op[c["op"]][1] += c["moved_bytes"]
    flops, bytes_accessed = float(m["flops"]), float(m["bytes"])
    temp = max(m["peak_bytes"] - m["argument_bytes"], 0)
    t_compute = flops / HW["peak_flops_bf16"]
    hbm_traffic = m["argument_bytes"] + m["output_bytes"] + 2 * temp
    t_memory = hbm_traffic / HW["hbm_bw"]
    t_memory_hlo = bytes_accessed / HW["hbm_bw"]
    t_coll = moved / (HW["nvlink_links"] * HW["nvlink_bw_per_link"])

    # MODEL_FLOPS (whole step, all chips)
    n_p = cfg.n_params()
    n_a = cfg.n_active_params()
    if shape.kind == "train":
        model_flops = 6 * n_a * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_a * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_a * shape.global_batch
    model_flops_per_chip = model_flops / n_chips
    worst = max(t_compute, t_memory, t_coll)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_kind,
        "n_chips": n_chips,
        "t_lower_s": 0.0, "t_compile_s": round(m["seconds"], 2),
        "memory": {
            "argument_bytes": m["argument_bytes"],
            "output_bytes": m["output_bytes"],
            "temp_bytes": temp,
            "alias_bytes": m["alias_bytes"],
            "peak_estimate_bytes": m["peak_bytes"],
            "hbm_bytes": HW["hbm_bytes"],
        },
        "cost": {
            "flops_per_device": flops,
            "bytes_accessed_per_device": bytes_accessed,
            "scan_corrected": False,
            "raw_flops_per_device": flops,
            "raw_bytes_per_device": bytes_accessed,
        },
        "collectives": {
            "moved_bytes_per_device": moved,
            "by_op": {k: {"count": v[0], "moved_bytes": v[1]}
                      for k, v in by_op.items()},
            "n_collectives": len(m["collectives"]),
        },
        "roofline": {
            "t_compute_s": t_compute,
            "t_memory_s": t_memory,
            "t_memory_hlo_s": t_memory_hlo,
            "hbm_traffic_bytes": hbm_traffic,
            "t_collective_s": t_coll,
            "dominant": max(
                [("compute", t_compute), ("memory", t_memory),
                 ("collective", t_coll)], key=lambda kv: kv[1])[0],
            "model_flops_total": model_flops,
            "model_flops_per_chip": model_flops_per_chip,
            "useful_flops_ratio": (model_flops_per_chip / flops) if flops else 0.0,
            "roofline_fraction": (
                model_flops_per_chip / HW["peak_flops_bf16"] / worst
            ) if worst > 0 else 0.0,
        },
        "params": {"total": n_p, "active": n_a},
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, force: bool = False,
             rules_override=None, tag: str = "", cfg_override=None) -> dict:
    ART_DIR.mkdir(parents=True, exist_ok=True)
    out_path = ART_DIR / f"{arch}__{shape_name}__{mesh_kind}{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
               "skipped": why}
        out_path.write_text(json.dumps(rec, indent=1))
        return rec

    n_chips = 512 if mesh_kind == "multi" else 256
    with fake_world(n_chips):
        # a cuda-typed mesh (make_production_mesh's): nothing touches a
        # card, the tensors are meta
        mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
        rules = (rules_override(mesh) if rules_override
                 else cell_rules(mesh, shape_name))
        m = trace_cell(cfg, shape, mesh, rules)
    rec = cell_record(arch, shape, mesh_kind, n_chips, cfg, m)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                key = f"{arch} × {shape} × {mesh_kind}"
                try:
                    rec = run_cell(arch, shape, mesh_kind, force=args.force)
                    if "skipped" in rec:
                        print(f"[skip] {key}: {rec['skipped']}", flush=True)
                    else:
                        r = rec["roofline"]
                        print(
                            f"[ ok ] {key}: trace={rec['t_compile_s']}s "
                            f"dom={r['dominant']} "
                            f"frac={r['roofline_fraction']:.3f} "
                            f"mem={rec['memory']['peak_estimate_bytes']/2**30:.2f}GiB",
                            flush=True)
                except Exception as e:
                    failures.append((key, repr(e)))
                    print(f"[FAIL] {key}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} failures:")
        for k, e in failures:
            print(" ", k, e)
        raise SystemExit(1)
    print("\nall requested dry-run cells passed")


if __name__ == "__main__":
    main()
