"""The port's dry run (``repro_torch.launch.dryrun``): its collective cost
model against the JAX package's, the H100 hardware model, and smoke cells
traced over a fake 4×4 process group in a subprocess (a process group is
global), held to the JAX package's record keys, its sharding specs and
its FLOP formulas.

The smoke cells are ``gemma-7b``'s smoke config (2 layers, width 64) at
batch 16 and 64 positions, ``train_4k``'s and ``prefill_32k``'s rules, on
a ``("data", "model")`` mesh of 4×4 fake ranks.  Tolerances: argument
bytes equal exactly; the prefill's per-device FLOPs summed over the 16
ranks lie within [1, 1.05] of the forward's (2 × the non-embedding
parameters × tokens, the last position's logits, and the attention
kernel's 4 × D × visible pairs × heads × rows, which the kernel's tally
must give exactly).
"""
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.configs.shapes import ShapeSpec as JaxShapeSpec
from repro.configs.shapes import input_specs as jax_input_specs
from repro.launch.dryrun import batch_pspecs as jax_batch_pspecs
from repro.launch.dryrun import cell_rules as jax_cell_rules
from repro.launch.dryrun import parse_collectives
from repro.models import build_model as jax_build_model
from repro.models.sharding import tree_pspecs as jax_tree_pspecs
from repro.train.optimizer import opt_state_pspecs as jax_opt_state_pspecs
from repro_torch.configs import smoke_config
from repro_torch.launch.dryrun import ring_moved_bytes
from repro_torch.launch.mesh import HW

REPO = Path(__file__).resolve().parents[1]
ARCH, B, T = "gemma-7b", 16, 64
MESH = {"data": 4, "model": 4}

HLO = """
  %all-reduce.1 = f32[32,64]{1,0} all-reduce(%dot.1), channel_id=1, replica_groups=[4,2]<=[2,4]T(1,0), use_global_device_ids=true, to_apply=%add
  %ag = bf16[128,256]{1,0} all-gather(%p0), channel_id=2, replica_groups=[16,16]<=[256], dimensions={0}
  %rs = bf16[8,256]{1,0} reduce-scatter(%p1), channel_id=3, replica_groups=[16,16]<=[256], to_apply=%add
  %cp = f32[64]{0} collective-permute(%p2), source_target_pairs={{0,1}}
  %aa = bf16[4,4]{1,0} all-to-all(%p3), replica_groups={{0,1,2,3}}
"""

# the JAX package's record of a cell (src/repro/launch/dryrun.py:351-407)
RECORD_KEYS = {
    None: {"arch", "shape", "mesh", "n_chips", "t_lower_s", "t_compile_s",
           "memory", "cost", "collectives", "roofline", "params"},
    "memory": {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_estimate_bytes", "hbm_bytes"},
    "cost": {"flops_per_device", "bytes_accessed_per_device",
             "scan_corrected", "raw_flops_per_device", "raw_bytes_per_device"},
    "collectives": {"moved_bytes_per_device", "by_op", "n_collectives"},
    "roofline": {"t_compute_s", "t_memory_s", "t_memory_hlo_s",
                 "hbm_traffic_bytes", "t_collective_s", "dominant",
                 "model_flops_total", "model_flops_per_chip",
                 "useful_flops_ratio", "roofline_fraction"},
    "params": {"total", "active"},
}

CELL = """
import json, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as dr

out = {}
cfg = smoke_config(%(arch)r)
for name, kind in (("train_4k", "train"), ("prefill_32k", "prefill")):
    shape = ShapeSpec(name, %(T)d, %(B)d, kind)
    with dr.fake_world(16):
        mesh = init_device_mesh("cuda", (4, 4),
                                mesh_dim_names=("data", "model"))
        m = dr.trace_cell(cfg, shape, mesh, dr.cell_rules(mesh, name))
    rec = dr.cell_record(%(arch)r, shape, "4x4", 16, cfg, m)
    out[kind] = {"record": rec, "trace": {k: v for k, v in m.items()
                                          if k != "collectives"}}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "cells.json"
    proc = subprocess.run(
        [sys.executable, "-c", CELL % dict(arch=ARCH, B=B, T=T), str(path)],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(path.read_text())


def test_ring_cost_model_equals_the_reference():
    colls = parse_collectives(HLO)
    assert len(colls) == 5
    for c in colls:
        assert ring_moved_bytes(c["op"], c["result_bytes"], c["group"]) == \
            pytest.approx(c["moved_bytes"], rel=0, abs=0), c["op"]


def test_hw_constants_are_the_h100s():
    assert HW["peak_flops_bf16"] == 989e12
    assert HW["hbm_bw"] == 3.35e12
    assert HW["nvlink_links"] * HW["nvlink_bw_per_link"] == 450e9
    assert HW["hbm_bytes"] == 80 * 10**9
    assert not any(k.startswith("ici") for k in HW)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_record_keys_equal_the_reference(cells, kind):
    rec = cells[kind]["record"]
    assert set(rec) == RECORD_KEYS[None]
    for k, keys in RECORD_KEYS.items():
        if k is not None:
            assert set(rec[k]) == keys, k
    assert rec["cost"]["scan_corrected"] is False


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_records_are_wellformed(cells, kind):
    rec = cells[kind]["record"]
    rl = rec["roofline"]
    assert rl["t_compute_s"] > 0 and rl["t_memory_s"] > 0
    assert rl["t_collective_s"] > 0
    assert rl["dominant"] in ("compute", "memory", "collective")
    assert 0 <= rl["roofline_fraction"] <= 1.2
    assert rec["collectives"]["n_collectives"] == sum(
        v["count"] for v in rec["collectives"]["by_op"].values())
    mem = rec["memory"]
    assert mem["peak_estimate_bytes"] >= mem["argument_bytes"] > 0


def _local_bytes(tree, specs):
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))):
        split = 1
        for a in spec:
            for name in (a if isinstance(a, tuple) else (a,) if a else ()):
                split *= MESH[name]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // split
    return total


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_argument_bytes_are_the_reference_specs_shards(cells, kind):
    """Per-device argument bytes: the params (and for train the optimizer
    state and step counters) and the batch, each leaf's bytes over the
    mesh axes its JAX spec names."""
    jcfg = jax_smoke_config(ARCH)
    model = jax_build_model(jcfg)
    rules = jax_cell_rules(SimpleNamespace(shape=MESH),
                           "train_4k" if kind == "train" else "prefill_32k")
    shape = JaxShapeSpec("cell", T, B, kind)
    batch = jax_input_specs(jcfg, shape)
    b_specs = jax_batch_pspecs(batch, rules)
    if kind == "train":
        state = jax.eval_shape(lambda: model.init_train_state(jax.random.key(0)))
        p_specs = jax_tree_pspecs(state.params, rules)
        o_specs = jax_opt_state_pspecs(state.opt, p_specs)
        want = (_local_bytes(state.params, p_specs)
                + _local_bytes(state.opt, o_specs) + 4)
    else:
        params = jax.eval_shape(lambda: model.init(jax.random.key(0)))
        want = _local_bytes(params, jax_tree_pspecs(params, rules))
    want += _local_bytes(batch, b_specs)
    got = cells[kind]["record"]["memory"]["argument_bytes"]
    assert got == want
    assert cells[kind]["trace"]["argument_bytes_by_rules"] == want


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_model_flops_follow_the_reference_formula(cells, kind):
    cfg = smoke_config(ARCH)
    n_a = cfg.n_active_params()
    rl = cells[kind]["record"]["roofline"]
    want = (6 if kind == "train" else 2) * n_a * B * T
    assert rl["model_flops_total"] == want
    assert rl["model_flops_per_chip"] == want / 16


def test_traced_prefill_flops_are_the_forwards(cells):
    cfg = smoke_config(ARCH)
    trace = cells["prefill"]["trace"]
    emb = cfg.vocab_size * cfg.d_model
    pairs = T * (T + 1) // 2
    attention = cfg.n_layers * 4 * cfg.head_dim * pairs * cfg.n_heads * B
    forward = (2 * (cfg.n_active_params() - emb) * B * T + attention
               + 2 * emb * B)  # the last position's logits
    assert trace["kernel_flops"] * 16 == attention
    assert trace["kernel_calls"] == cfg.n_layers
    total = trace["flops"] * 16
    assert forward <= total <= 1.05 * forward
