"""Sharding that computes: the port's prefill, decode and train steps on
DTensors over a real 4-rank ``gloo`` group on the CPU, held to the
unsharded port and to the JAX package.

The smoke dense (``minitron-4b``, GQA 4 / 2 heads), MoE
(``granite-moe-1b-a400m``) and SSM (``falcon-mamba-7b``) models run on a
2×2 ``("data", "model")`` mesh, and the dense one also on 1×4, where its
two KV heads do not divide the model axis: q's heads are sharded and each
rank cuts k / v to its own KV heads, and the decode cache is sharded by
its slots.  Parameters come from the JAX package (``params_from_jax``),
inputs from a seeded numpy generator; each rank places them by the dry
run's rules and runs one prefill (its last-token logits), one decode step
on that prefill's cache (its logits), one ``grad_step`` (every gradient
leaf: a data-parallel reduction taken twice, or summed where it should be
averaged, scales a gradient, which the first AdamW step's ``g / |g|``
would hide) and one train step (the loss and every updated parameter).
Each result is held to the unsharded port's
and to JAX's within the fp32 tolerance 2e-5 (|a - b| <= 2e-5 + 2e-5 |b|).
The group runs in a subprocess (``tests/torch_sharded_worker.py``): a
process group is global.  This is the one place where the port's
sharding computes on more than one device; nothing of it is claimed for
the card.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.tree import leaves_with_path, map_tree

REPO = Path(__file__).resolve().parents[1]
TOL = 2e-5
CASES = [("minitron-4b", (2, 2)), ("minitron-4b", (1, 4)),
         ("granite-moe-1b-a400m", (2, 2)), ("falcon-mamba-7b", (2, 2))]
B, T, MAX_LEN = 4, 12, 16


def _ids(case):
    return f"{case[0]}-{case[1][0]}x{case[1][1]}"


def _inputs(arch):
    cfg = smoke_config(arch)
    rng = np.random.default_rng(29)
    return {
        "prompt": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
        "next": rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32),
        "batch": rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32),
    }


def _jax_side(arch, jparams, x):
    jmodel = jax_build_model(jax_smoke_config(arch))
    lp, cache = jmodel.prefill_step(jparams, {"tokens": jnp.asarray(x["prompt"])},
                                    max_len=MAX_LEN)
    ld, _ = jmodel.decode_step(jparams, cache, jnp.asarray(x["next"]),
                               jnp.full((B,), T, jnp.int32))
    state = jmodel.init_train_state(jax.random.key(0))
    state = state._replace(params=jparams)
    _, grads = jmodel.grad_step(jparams, {"tokens": jnp.asarray(x["batch"])})
    state, metrics = jmodel.train_step(state,
                                       {"tokens": jnp.asarray(x["batch"])})
    return {"prefill_logits": np.asarray(lp), "decode_logits": np.asarray(ld),
            "loss": np.asarray(metrics["loss"]),
            "grads": jax.tree.map(np.asarray, grads),
            "params": jax.tree.map(np.asarray, state.params)}


def _port_side(arch, params, x):
    cfg = smoke_config(arch)
    model = build_model(cfg, "cpu")
    lp, cache = model.prefill_step(params,
                                   {"tokens": torch.from_numpy(x["prompt"])},
                                   max_len=MAX_LEN)
    ld, _ = model.decode_step(params, cache, torch.from_numpy(x["next"]),
                              torch.full((B,), T, dtype=torch.int32))
    state = model.init_train_state(0)
    state = state._replace(params=map_tree(lambda t: t.clone(), params))
    _, grads = model.grad_step(state.params,
                               {"tokens": torch.from_numpy(x["batch"])})
    state, metrics = model.train_step(
        state, {"tokens": torch.from_numpy(x["batch"])})
    return {"prefill_logits": lp, "decode_logits": ld,
            "loss": metrics["loss"], "grads": grads, "params": state.params}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{case: (sharded, unsharded port, JAX)}`` results."""
    work = tmp_path_factory.mktemp("sharded")
    cases, port, ref = [], {}, {}
    for arch, mesh in CASES:
        jparams = jax_build_model(jax_smoke_config(arch)).init(
            jax.random.key(0))
        params = params_from_jax(smoke_config(arch),
                                 jax.tree.map(np.asarray, jparams), "cpu")
        x = _inputs(arch)
        if arch not in ref:
            ref[arch] = _jax_side(arch, jparams, x)
            port[arch] = _port_side(arch, map_tree(lambda t: t.clone(), params),
                                    x)
        cases.append({"arch": arch, "mesh": mesh, "params": params,
                      "prompt": torch.from_numpy(x["prompt"]),
                      "next": torch.from_numpy(x["next"]),
                      "batch": {"tokens": torch.from_numpy(x["batch"])},
                      "max_len": MAX_LEN})
    torch.save(cases, work / "cases.pt")
    proc = subprocess.run(
        [sys.executable, str(REPO / "tests" / "torch_sharded_worker.py"),
         str(work / "cases.pt"), str(work / "results.pt"), str(work)],
        capture_output=True, text=True, timeout=600,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    sharded = torch.load(work / "results.pt", weights_only=False)
    return {case: (got, port[case[0]], ref[case[0]])
            for case, got in zip(CASES, sharded)}


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    assert (err <= TOL + TOL * np.abs(want)).all(), (
        f"{what}: max abs err {err.max()}")


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("what", ["prefill_logits", "decode_logits", "loss"])
def test_sharded_step_matches_port_and_jax(runs, case, what):
    got, port, ref = runs[case]
    _close(got[what], port[what], f"{_ids(case)} {what} vs the port")
    _close(got[what], ref[what], f"{_ids(case)} {what} vs JAX")


def _close_trees(case, got, port, ref):
    """Every leaf of ``got`` (a port tree) within the tolerance of the
    unsharded port's and of JAX's (a JAX tree, converted)."""
    want_port = dict(leaves_with_path(port))
    want_jax = dict(leaves_with_path(params_from_jax(smoke_config(case[0]),
                                                     ref, "cpu")))
    pairs = list(leaves_with_path(got))
    assert len(pairs) == len(want_port) == len(want_jax)
    for path, t in pairs:
        name = "/".join(map(str, path))
        _close(t, want_port[path], f"{_ids(case)} {name} vs the port")
        _close(t, want_jax[path], f"{_ids(case)} {name} vs JAX")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_grads_match_port_and_jax(runs, case):
    got, port, ref = runs[case]
    assert got["grads_placed_as_params"], _ids(case)
    _close_trees(case, got["grads"], port["grads"], ref["grads"])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_sharded_train_step_updates_params_as_port_and_jax(runs, case):
    got, port, ref = runs[case]
    _close_trees(case, got["params"], port["params"], ref["params"])
