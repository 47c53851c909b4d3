"""The dense family's last two head ratios, the port against the JAX
package on the CPU.

The smoke configs cut every model to 4 query heads over at most 2, so no
other test sees ``mistral-large-123b``'s 96 over 8 (a group of 12, which
the decode kernel cuts into two chunks of blocks on the card) or
``pixtral-12b``'s 32 over 8 (a group of 4).  These narrow models keep
each ratio, the rest of the smoke config (``mistral-large-123b``'s int8
KV cache and factored second moment, ``pixtral-12b``'s patch
embeddings) and two layers:

- at mistral's ratio (24 query heads over 2, head dim 16): prefill and
  decode logits, the greedy streams of both packages' ``ServeEngine``, and
  one ``train_step``'s loss, updated parameters and factored moments;
- at pixtral's ratio (8 over 2) with seeded ``patch_embeds``: the prefill
  logits, and the loss and every gradient leaf of a step fed the patches.

Inputs are made from numpy seeds and the JAX parameters from
``jax.random.key(0)``, carried into the port with ``params_from_jax`` /
``train_state_from_jax``.  Logits agree within atol = rtol = 1e-4 in
fp32 (as ``tests/test_torch_model.py``: XLA:CPU and PyTorch sum in other
orders, and an int8 cache may round an element on the other side of a
half); a train step's loss, parameters and moments within 2e-5, and its
gradients within rtol 1e-4 / atol 1e-5 (``tests/test_torch_train.py``).
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from numpy.testing import assert_allclose

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import params_from_jax, train_state_from_jax
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.tree import leaves_with_path
from torch_trees import assert_trees_close

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# the narrow models: each full model's query heads a kv head, two kv heads
RATIOS = {"mistral-large-123b": dict(n_heads=24, n_kv_heads=2, head_dim=16),
          "pixtral-12b": dict(n_heads=8, n_kv_heads=2, head_dim=16)}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _cfgs(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **RATIOS[arch])
    tcfg = dataclasses.replace(smoke_config(arch), **RATIOS[arch])
    assert vars(jcfg) == vars(tcfg)
    return jcfg, tcfg


def _state(arch):
    """Both configs, models and train states (the JAX one carried into the
    port)."""
    jcfg, tcfg = _cfgs(arch)
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.key(0))
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  "cpu")
    return jcfg, tcfg, jmodel, jstate, build_model(tcfg, "cpu"), tstate


def _assert_trees_close(got, want_jax, cfg, **tol):
    want = params_from_jax(cfg, jax.tree.map(np.asarray, want_jax), "cpu")
    return assert_trees_close(got, want, **tol)


@pytest.mark.parametrize("arch", sorted(RATIOS))
def test_the_narrow_models_keep_each_full_models_ratio(arch):
    smoke, cfg, full = smoke_config(arch), _cfgs(arch)[1], get_config(arch)
    assert smoke.n_heads // smoke.n_kv_heads == 2
    assert cfg.n_heads // cfg.n_kv_heads == full.n_heads // full.n_kv_heads
    assert (cfg.kv_cache_dtype, cfg.optimizer_moments, cfg.frontend,
            cfg.n_layers) == (full.kv_cache_dtype, full.optimizer_moments,
                              full.frontend, 2)


# ---------------------------------------------------- mistral's ratio (12)
def test_mistral_ratio_prefill_and_decode_match_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _state("mistral-large-123b")
    jparams, tparams = jstate.params, tstate.params
    rng = np.random.default_rng(3)
    B, T, max_len, steps = 2, 12, 40, 10
    prompt = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    dec.DISPATCHES.reset()
    lj, cj = jmodel.prefill_step(jparams, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    lt, ct = tmodel.prefill_step(tparams, {"tokens": torch.from_numpy(prompt)},
                                 max_len=max_len)
    assert lt.shape == (B, tcfg.vocab_size)
    assert_allclose(_np(lt), np.asarray(lj), **TOL)
    assert {t.dtype for _, t in leaves_with_path(ct)} >= {torch.int8}
    # ragged rows: row 1 resumes at 9
    lens = np.array([T, 9], np.int32)
    decode = jax.jit(jmodel.decode_step)
    for _ in range(steps):
        tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        lj, cj = decode(jparams, cj, jnp.asarray(tok), jnp.asarray(lens))
        lt, ct = tmodel.decode_step(tparams, ct, torch.from_numpy(tok),
                                    torch.from_numpy(lens))
        assert_allclose(_np(lt), np.asarray(lj), **TOL)
        lens = lens + 1
    assert dec.DISPATCHES.launches == steps * tcfg.n_layers
    assert dec.DISPATCHES.rows == steps * tcfg.n_layers * B * tcfg.n_heads


def test_mistral_ratio_engine_streams_match_jax():
    jcfg, tcfg = _cfgs("mistral-large-123b")
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


def test_mistral_ratio_train_step_matches_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _state("mistral-large-123b")
    assert tcfg.optimizer_moments == "factored"
    attn = tstate.opt["mu"]["layers"][0]["attn"]
    assert attn["wq"]["v_row"].shape == (tcfg.d_model,)
    assert attn["wq"]["v_col"].shape == (tcfg.n_heads * tcfg.head_dim,)
    tok = np.random.default_rng(10).integers(
        0, tcfg.vocab_size, (4, 33)).astype(np.int32)
    jstate, jm = jax.jit(jmodel.train_step)(jstate,
                                            {"tokens": jnp.asarray(tok)})
    fa.DISPATCHES.reset()
    fa.BWD_DISPATCHES.reset()
    tstate, tm = tmodel.train_step(tstate, {"tokens": torch.from_numpy(tok)})
    assert fa.BWD_DISPATCHES.launches == tcfg.n_layers
    assert_allclose(float(tm["loss"]), float(jm["loss"]), **STEP_TOL)
    assert int(tm["step"]) == int(jm["step"]) == 1
    _assert_trees_close(tstate.params, jstate.params, tcfg, **STEP_TOL)
    paths = _assert_trees_close(tstate.opt["mu"], jstate.opt["mu"], tcfg,
                                **STEP_TOL)
    factored = [p for p in paths if p[-1] in ("v_row", "v_col")]
    # every 2-D weight of both layers, the embedding and the head
    assert len(factored) == 2 * (7 * tcfg.n_layers + 2)


# ----------------------------------------------------- pixtral's ratio (4)
def _patch_batch(cfg, rng, B, T):
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
            "patch_embeds": rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)).astype(np.float32)}


def test_pixtral_ratio_prefill_with_patches_matches_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _state("pixtral-12b")
    batch = _patch_batch(tcfg, np.random.default_rng(8), 2, 12)
    lj, _ = jmodel.prefill_step(jstate.params, jax.tree.map(jnp.asarray,
                                                            batch), max_len=40)
    lt, _ = tmodel.prefill_step(tstate.params, {
        k: torch.from_numpy(v) for k, v in batch.items()}, max_len=40)
    assert_allclose(_np(lt), np.asarray(lj), **TOL)
    # the splice took effect: without the patches, other logits
    bare, _ = tmodel.prefill_step(tstate.params, {
        "tokens": torch.from_numpy(batch["tokens"])}, max_len=40)
    assert float((bare - lt).abs().max()) > 100 * TOL["atol"]


def test_pixtral_ratio_train_step_with_patches_matches_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _state("pixtral-12b")
    batch = _patch_batch(tcfg, np.random.default_rng(9), 4, 33)
    jbatch = jax.tree.map(jnp.asarray, batch)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jg = jmodel.grad_step(jstate.params, jbatch)
    fa.BWD_DISPATCHES.reset()
    tl, tg = tmodel.grad_step(tstate.params, tbatch)
    assert fa.BWD_DISPATCHES.launches == tcfg.n_layers
    assert_allclose(float(tl), float(jl), **STEP_TOL)
    _assert_trees_close(tg, jg, tcfg, **GRAD_TOL)
    # the patches reach the loss: without them, another loss
    bare, _ = tmodel.grad_step(tstate.params, {"tokens": tbatch["tokens"]})
    assert abs(float(bare) - float(tl)) > 1e-3
    jstate, jm = jax.jit(jmodel.train_step)(jstate, jbatch)
    tstate, tm = tmodel.train_step(tstate, tbatch)
    assert_allclose(float(tm["loss"]), float(jm["loss"]), **STEP_TOL)
    _assert_trees_close(tstate.params, jstate.params, tcfg, **STEP_TOL)
