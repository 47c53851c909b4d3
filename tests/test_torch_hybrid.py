"""The hybrid ``jamba-1.5-large-398b`` (Mamba beside attention, MoE every
other layer, an int8 KV cache) in the port against the JAX package, on the
CPU.

Its smoke config has 9 layers: one scanned group of 8 (7 Mamba mixers and
one attention mixer at offset 4) and one Mamba layer in the tail, so its
decode cache's group positions hold Mamba states and KV rings side by
side.  The JAX parameters (``jax.random.key(0)``) carried across with
``params_from_jax`` give prefill logits within 1e-4 and decode logits
over ragged rows within 1e-4, caches within 1e-4 (an int8 slot at most one
quantisation step apart), identical greedy streams from the two engines,
and the loss (rtol 1e-5), every gradient leaf (rtol 1e-4, atol 1e-5) and
two ``train_step``s with factored moments as the JAX package computes
them.  The tolerances are those of fp32 sums taken in other orders by
XLA:CPU and PyTorch.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from numpy.testing import assert_allclose

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models.transformer import init_decode_cache as jax_cache
from repro.runtime.ft import FTConfig as JaxFTConfig
from repro.runtime.ft import FTTrainer as JaxFTTrainer
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax, train_state_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms_pkg
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model
from repro_torch.models.transformer import (init_decode_cache, layer_cache,
                                            layer_kinds)
from repro_torch.runtime.ft import FTConfig, FTTrainer
from repro_torch.serve import ServeEngine
from repro_torch.tree import leaves_with_path
from torch_trees import assert_trees_close, bf16_ulps_apart

ARCH = "jamba-1.5-large-398b"
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_side(items):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **dict(items))
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.key(0))
    return jcfg, jmodel, jstate, jax.tree.map(np.asarray, jstate)


def _both(**kw):
    """Both models at the smoke config, the port's state a fresh copy of
    the JAX one (the port updates its state in place)."""
    jcfg, jmodel, jstate, tree = _jax_side(tuple(sorted(kw.items())))
    tcfg = dataclasses.replace(smoke_config(ARCH), **kw)
    assert vars(jcfg) == vars(tcfg)
    return (jcfg, tcfg, jmodel, jstate, build_model(tcfg, "cpu"),
            train_state_from_jax(tcfg, tree, "cpu"))


def _assert_trees_close(got, want_jax, cfg, **tol):
    want = params_from_jax(cfg, jax.tree.map(np.asarray, want_jax), "cpu")
    assert_trees_close(got, want, **tol)


def _tokens(cfg, B=4, T=33, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


# ------------------------------------------------------------ the layout
def test_smoke_plan_is_one_mixed_group_and_a_tail():
    cfg = smoke_config(ARCH)
    kinds = layer_kinds(cfg)
    assert cfg.group_len == 8 and cfg.n_layers == 9
    assert [m for m, _ in kinds] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 4
    assert [f for _, f in kinds] == ["dense", "moe"] * 4 + ["dense"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_cache_layout_matches_jax(dtype):
    cfg = smoke_config(ARCH).replace(dtype=dtype)
    tc = init_decode_cache(cfg, 3, 40, "cpu")
    jc = jax_cache(jax_smoke_config(ARCH).replace(dtype=dtype), 3, 40)
    assert set(tc) == set(jc) == {"groups", "tail"}
    for head in tc:
        assert len(tc[head]) == len(jc[head])
        for t_layer, j_layer in zip(tc[head], jc[head]):
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                    for k, v in t_layer.items()} == \
                {k: (tuple(v.shape), str(v.dtype))
                 for k, v in j_layer.items()}
    # the group's positions: Mamba states beside one int8 KV ring
    assert [sorted(p) for p in tc["groups"]] == \
        [["conv", "h"]] * 4 + [["k", "k_scale", "v", "v_scale"]] + \
        [["conv", "h"]] * 3
    assert tc["groups"][4]["k"].dtype == torch.int8


def test_params_from_jax_carries_the_mixed_groups():
    cfg = smoke_config(ARCH).replace(dtype="bfloat16")
    jparams = jax_build_model(jax_smoke_config(ARCH).replace(
        dtype="bfloat16")).init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    got = params_from_jax(cfg, tree, "cpu")
    built = build_model(cfg, "cpu").init(0)
    shapes = [[(path, tuple(t.shape), t.dtype)
               for path, t in leaves_with_path(p)] for p in (got, built)]
    assert shapes[0] == shapes[1]
    for i, (mixer, ffn) in enumerate(layer_kinds(cfg)):
        layer = got["layers"][i]
        assert ("mamba" in layer) == (mixer == "mamba")
        assert ("attn" in layer) == (mixer == "attn")
        assert ("router" in layer["ffn"]) == (ffn == "moe")
        src = tree["groups"][i] if i < 8 else tree["tail"][0]
        idx = 0 if i < 8 else ...
        mix = "mamba" if mixer == "mamba" else "attn"
        for name, leaf in layer[mix].items():
            want = np.asarray(src[mix][name][idx], np.float32)
            assert np.array_equal(_np(leaf), want), (i, name)
        if mixer == "mamba":
            # the fp32 leaves of a bf16 model stay fp32
            assert layer["mamba"]["A_log"].dtype == torch.float32
            assert layer["mamba"]["Dp"].dtype == torch.float32
            assert layer["mamba"]["in_proj"].dtype == torch.bfloat16


# -------------------------------------------------------------- serving
def test_prefill_and_decode_match_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both()
    jparams, tparams = jstate.params, tstate.params
    rng = np.random.default_rng(3)
    B, T, max_len = 2, 12, 40
    prompt = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    lj, cj = jmodel.prefill_step(jparams, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    lt, ct = tmodel.prefill_step(tparams, {"tokens": torch.from_numpy(prompt)},
                                 max_len=max_len)
    assert lt.shape == (B, tcfg.vocab_size)
    assert_allclose(_np(lt), np.asarray(lj), **TOL)
    # ragged rows: row 1 resumes at 9
    lens = np.array([T, 9], np.int32)
    decode = jax.jit(jmodel.decode_step)
    for _ in range(4):
        tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        lj, cj = decode(jparams, cj, jnp.asarray(tok), jnp.asarray(lens))
        lt, ct = tmodel.decode_step(tparams, ct, torch.from_numpy(tok),
                                    torch.from_numpy(lens))
        assert_allclose(_np(lt), np.asarray(lj), **TOL)
        lens = lens + 1
    kinds = {"mamba": 0, "attn": 0}
    for i, (mixer, _) in enumerate(layer_kinds(tcfg)):
        lj_ = layer_cache(jax.tree.map(lambda a: torch.tensor(
            np.asarray(a, np.float32)), cj), tcfg, i)
        lt_ = layer_cache(ct, tcfg, i)
        kinds[mixer] += 1
        for b, n in enumerate(lens):
            if mixer == "mamba":
                for name in ("conv", "h"):
                    assert_allclose(_np(lt_[name][b]), _np(lj_[name][b]),
                                    err_msg=f"layer {i} {name}", **TOL)
                continue
            for name in ("k", "v"):
                a, g = _np(lj_[name][b, :, :n]), _np(lt_[name][b, :, :n])
                # int8: at most one quantisation step apart
                assert np.abs(a - g).max() <= 1, (i, name)
                assert np.mean(a != g) < 0.01, (i, name)
                assert_allclose(_np(lt_[f"{name}_scale"][b, :, :n]),
                                _np(lj_[f"{name}_scale"][b, :, :n]), **TOL)
    assert kinds == {"mamba": 8, "attn": 1}


def test_engine_token_streams_match_jax():
    jcfg, tcfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n) for n in (5, 21, 9) * 2]
    jeng = JaxServeEngine(jcfg, jparams, max_batch=4, max_len=64)
    jreqs = [jeng.submit(p, max_new_tokens=12) for p in prompts]
    jeng.run_until_drained()
    teng = ServeEngine(tcfg, tparams, max_batch=4, max_len=64, device="cpu")
    treqs = [teng.submit(p, max_new_tokens=12) for p in prompts]
    teng.run_until_drained()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done and len(r.out_tokens) == 12 for r in treqs)
    # a workload whose streams all repeat one token would prove little
    assert sum(len(set(r.out_tokens)) > 1 for r in treqs) >= 3
    np.testing.assert_array_equal(teng.cache_len.numpy(),
                                  np.asarray(jeng.cache_len))


# ------------------------------------------------------------- training
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_leaf_match_jax(remat):
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both(remat=remat)
    tok = _tokens(tcfg)
    jl, jg = jmodel.grad_step(jstate.params, {"tokens": jnp.asarray(tok)})
    for stats in (ms_pkg.DISPATCHES, ms_pkg.BWD_DISPATCHES, fa.DISPATCHES,
                  fa.BWD_DISPATCHES):
        stats.reset()
    tl, tg = tmodel.grad_step(tstate.params, {"tokens": torch.from_numpy(tok)})
    # 8 Mamba layers and one attention layer, each forward twice under remat
    assert ms_pkg.DISPATCHES.launches == 8 * (1 + remat)
    assert ms_pkg.BWD_DISPATCHES.launches == 8
    assert fa.DISPATCHES.launches == 1 + remat
    assert fa.BWD_DISPATCHES.launches == 1
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _assert_trees_close(tg, jg, tcfg, **GRAD_TOL)


def test_two_train_steps_with_factored_moments_match_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both()
    assert tcfg.optimizer_moments == "factored"
    mu = tstate.opt["mu"]["layers"][0]["mamba"]
    assert mu["in_proj"]["v_row"].shape == (tcfg.d_model,)
    assert mu["in_proj"]["v_col"].shape == (2 * tcfg.d_inner,)
    assert mu["A_log"]["v_row"].dtype == torch.float32
    jstep = jax.jit(jmodel.train_step)
    for step in range(2):
        tok = _tokens(tcfg, seed=10 + step)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
        tstate, tm = tmodel.train_step(tstate,
                                       {"tokens": torch.from_numpy(tok)})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert int(tm["step"]) == int(jm["step"]) == step + 1
    _assert_trees_close(tstate.params, jstate.params, tcfg, rtol=1e-4,
                        atol=1e-5)
    # the bf16 first moments: two roundings apart at most (bf16_ulps_apart)
    _assert_trees_close(tstate.opt["mu"], jstate.opt["mu"], tcfg, rtol=1e-4,
                        atol=1e-6, excuse=bf16_ulps_apart(2))


def test_trainer_losses_match_jax_through_a_crash():
    kw = dict(n_hosts=2, global_batch=4, seq_len=16, ckpt_every=2)
    jcfg, tcfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jtr = JaxFTTrainer(jcfg, JaxFTConfig(**kw))
    tr = FTTrainer(tcfg, FTConfig(**kw), device="cpu")
    tr.state = train_state_from_jax(tcfg, jax.tree.map(np.asarray,
                                                       jtr.state), "cpu")
    got, want = [], []
    for t, out in ((tr, got), (jtr, want)):
        out += t.train_steps(2)
        t.crash_host(1)
        assert t.restore() == 2
        out += t.train_steps(1)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_launchers_serve_and_train_the_hybrid_smoke_config_on_cpu(capsys):
    reqs = serve_launcher.main(["--arch", ARCH, "--preset", "smoke",
                                "--device", "cpu", "--requests", "3",
                                "--max-new", "4"])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
    losses = train_launcher.main(["--arch", ARCH, "--preset", "smoke",
                                  "--device", "cpu", "--steps", "3",
                                  "--seq-len", "16"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "device=cpu" in capsys.readouterr().out
