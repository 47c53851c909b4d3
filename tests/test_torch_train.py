"""The port's training path against the JAX package's, on the CPU.

The same inputs, made from numpy seeds, go through both packages: the
synthetic data pipeline (bit-identical batches), AdamW under its three
moment policies (within 1e-6), the chunked cross-entropy, ``loss_fn``
(rtol 1e-5) and every gradient leaf (rtol 1e-4, atol 1e-5) from one state
carried across with ``train_state_from_jax``, two ``train_step``s with one
and two microbatches, and the attention backward (the plain version of
the CUDA kernel's formula) against ``jax.grad`` of the JAX reference
attention (2e-5 in fp32).  The tolerances are those of fp32 sums taken in
other orders by XLA:CPU and PyTorch.
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
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.models import build_model as jax_build_model
from repro.models.model import cross_entropy as jax_cross_entropy
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import SyntheticLM as JaxSyntheticLM
from repro.train.delta_sync import DeltaAggregator as JaxAggregator
from repro.train.delta_sync import GradDelta as JaxDelta
from repro.train.optimizer import AdamWConfig as JaxAdamW
from repro.train.optimizer import adamw_update as jax_adamw
from repro.train.optimizer import global_norm as jax_global_norm
from repro.train.optimizer import init_opt_state as jax_init_opt
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax, train_state_from_jax
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model
from repro_torch.models.model import cross_entropy
from repro_torch.train import (AdamWConfig, DataConfig, DeltaAggregator,
                               GradDelta, SyntheticLM, adamw_update,
                               init_opt_state)
from repro_torch.train.optimizer import global_norm
from repro_torch.tree import leaves
from torch_trees import assert_trees_close

# gemma3-27b cut to two layers (both local: the sliding window's backward)
ARCHS = [("minitron-4b", {}), ("gemma3-27b", {"n_layers": 2})]


def _np(t):
    return t.detach().float().numpy()


@functools.lru_cache(maxsize=None)
def _jax_side(arch, items):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **dict(items))
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.key(0))
    return jcfg, jmodel, jstate, jax.tree.map(np.asarray, jstate)


def _both(arch, **kw):
    """Both models at ``arch``'s smoke config (the port's updates its state
    in place, so each call carries a fresh copy across)."""
    jcfg, jmodel, jstate, tree = _jax_side(arch, tuple(sorted(kw.items())))
    tcfg = dataclasses.replace(smoke_config(arch), **kw)
    assert vars(jcfg) == vars(tcfg)
    tstate = train_state_from_jax(tcfg, tree, "cpu")
    return jcfg, tcfg, jmodel, jstate, build_model(tcfg, "cpu"), tstate


def _tokens(cfg, B=4, T=33, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _assert_trees_close(got, want_jax, cfg, **tol):
    """Every leaf of the port's tree against the JAX tree carried across."""
    want = params_from_jax(cfg, jax.tree.map(np.asarray, want_jax), "cpu")
    assert_trees_close(got, want, **tol)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("step,host,n_hosts", [(0, 0, 1), (3, 1, 2),
                                               (7, 2, 4), (11, 0, 3)])
def test_synthetic_batches_are_bit_identical(step, host, n_hosts):
    cfg = dict(vocab_size=503, seq_len=40, global_batch=12, seed=5)
    want = JaxSyntheticLM(JaxDataConfig(**cfg)).batch(step, host=host,
                                                      n_hosts=n_hosts)
    got = SyntheticLM(DataConfig(**cfg)).batch(step, host=host,
                                               n_hosts=n_hosts)
    assert got.keys() == want.keys()
    assert got["tokens"].dtype == want["tokens"].dtype
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


# ------------------------------------------------------------- optimizer
def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((16, 12)).astype(np.float32),
              "b": rng.standard_normal((12,)).astype(np.float32),
              "stack": [rng.standard_normal((3, 8, 10)).astype(np.float32)]}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * s)
                          .astype(np.float32), params) for s in (0.3, 2.0)]
    return params, grads


@pytest.mark.parametrize("moments", ["fp32", "bf16", "factored"])
def test_adamw_matches_jax(moments):
    params, grads = _opt_inputs(1)
    jcfg, tcfg = JaxAdamW(moments=moments), AdamWConfig(moments=moments)
    jp = jax.tree.map(jnp.asarray, params)
    jst = jax_init_opt(jp, jcfg)
    tp = jax.tree.map(torch.tensor, params)
    tst = init_opt_state(tp, tcfg)
    for g in grads:   # the second step clips (global norm above 1)
        jp, jst = jax_adamw(jax.tree.map(jnp.asarray, g), jst, jp, jcfg)
        tp, tst = adamw_update(jax.tree.map(torch.tensor, g), tst, tp, tcfg)
    assert int(tst["step"]) == int(jst["step"]) == 2
    for got, want in zip(leaves(tp), jax.tree.leaves(jp)):
        assert_allclose(_np(got), np.asarray(want, np.float32), atol=1e-6,
                        rtol=1e-6)
    jmu = jax.tree.leaves(jst["mu"])
    tmu = leaves(tst["mu"])
    assert len(jmu) == len(tmu)
    for got, want in zip(tmu, jmu):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        assert_allclose(_np(got), np.asarray(want, np.float32), atol=1e-6,
                        rtol=1e-6)


def test_global_norm_matches_jax():
    params, grads = _opt_inputs(2)
    want = float(jax_global_norm(jax.tree.map(jnp.asarray, grads[1])))
    got = float(global_norm(jax.tree.map(torch.tensor, grads[1])))
    assert got == pytest.approx(want, rel=1e-6)


# --------------------------------------------------------- loss and grads
@pytest.mark.parametrize("T", [16, 1100])
def test_chunked_cross_entropy_matches_jax(T):
    """At T = 1100 the CE runs two 512-position chunks and a remainder."""
    jcfg, tcfg, _, jstate, _, tstate = _both("minitron-4b")
    rng = np.random.default_rng(4)
    hidden = rng.standard_normal((2, T, tcfg.d_model)).astype(np.float32)
    targets = rng.integers(0, tcfg.vocab_size, (2, T)).astype(np.int32)
    mask = (rng.random((2, T)) > 0.2).astype(np.float32)
    want = jax_cross_entropy(jstate.params, jcfg, jnp.asarray(hidden),
                             jnp.asarray(targets), jnp.asarray(mask))
    got = cross_entropy(tstate.params, tcfg, torch.from_numpy(hidden),
                        torch.from_numpy(targets), torch.from_numpy(mask))
    assert float(got) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("arch,kw", ARCHS, ids=[a for a, _ in ARCHS])
def test_loss_and_every_gradient_leaf_match_jax(arch, kw):
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both(arch, **kw)
    tok = _tokens(tcfg)
    jl, jg = jmodel.grad_step(jstate.params, {"tokens": jnp.asarray(tok)})
    tl, tg = tmodel.grad_step(tstate.params, {"tokens": torch.from_numpy(tok)})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _assert_trees_close(tg, jg, tcfg, rtol=1e-4, atol=1e-5)


def test_remat_keeps_loss_and_gradients():
    """``cfg.remat`` recomputes each layer in the backward: the same
    values, with the attention forward run twice a layer."""
    cfg = smoke_config("minitron-4b")
    params = build_model(cfg, "cpu").init(0)
    tok = torch.from_numpy(_tokens(cfg))
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
        fa.DISPATCHES.reset()
        fa.BWD_DISPATCHES.reset()
        out[remat] = model.grad_step(params, {"tokens": tok})
        assert fa.DISPATCHES.launches == cfg.n_layers * (1 + remat)
        assert fa.BWD_DISPATCHES.launches == cfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(leaves(out[True][1]), leaves(out[False][1])):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)


def test_gradients_reach_the_attention_projections():
    cfg = smoke_config("minitron-4b")
    model = build_model(cfg, "cpu")
    _, grads = model.grad_step(model.init(0),
                               {"tokens": torch.from_numpy(_tokens(cfg))})
    for layer in grads["layers"]:
        for name in ("wq", "wk", "wv", "wo"):
            assert float(layer["attn"][name].abs().sum()) > 0, name


@pytest.mark.parametrize("mbs", [1, 2])
def test_two_train_steps_match_jax(mbs):
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both(
        "minitron-4b", n_microbatches=mbs)
    jstep = jax.jit(jmodel.train_step)
    for step in range(2):
        tok = _tokens(tcfg, seed=10 + step)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
        tstate, tm = tmodel.train_step(tstate, {"tokens": torch.from_numpy(tok)})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert int(tm["step"]) == int(jm["step"]) == step + 1
    _assert_trees_close(tstate.params, jstate.params, tcfg, rtol=1e-4,
                        atol=1e-5)
    _assert_trees_close(tstate.opt["mu"], jstate.opt["mu"], tcfg, rtol=1e-4,
                        atol=1e-6)


# ---------------------------------------------------- attention backward
@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,causal,window", [
    (1, 2, 2, 24, 24, 16, True, None),      # causal MHA
    (2, 4, 2, 40, 40, 16, True, 8),         # windowed GQA
    (1, 6, 2, 17, 29, 32, True, None),      # GQA, queries at the tail
    (1, 4, 1, 33, 33, 8, False, None),      # non-causal, one KV head
    (1, 2, 2, 1100, 1100, 8, True, 300),    # two query chunks, a window
])
def test_attention_backward_matches_jax_grad(B, Hq, Hkv, T, S, D, causal,
                                             window):
    rng = np.random.default_rng(T + Hq)
    q = rng.standard_normal((B, Hq, T, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    dout = rng.standard_normal((B, Hq, T, D)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_attention(q, k, v, causal=causal, window=window)
                       * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)


def test_attention_function_only_under_autograd():
    """Under no_grad, or with no input that requires grad, a call is the
    serve path's: no lse, no Function, one forward count."""
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k, v = torch.randn(1, 2, 8, 16), torch.randn(1, 2, 8, 16)
    fa.DISPATCHES.reset()
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert fa.flash_attention(q.detach(), k, v).grad_fn is None
    assert fa.flash_attention(q, k, v).grad_fn is not None
    assert fa.DISPATCHES.launches == 3
    assert fa.DISPATCHES.kernel_launches == 0


def test_lse_of_a_row_that_sees_no_key_is_inf():
    q, k = torch.randn(1, 1, 6, 8), torch.randn(1, 1, 3, 8)
    lse = fa.attention_lse_ref(q, k, causal=True)
    assert torch.isinf(lse[0, 0, :3]).all() and torch.isfinite(lse[0, 0, 3:]).all()
    v = torch.randn(1, 1, 3, 8)
    o = fa.attention_ref(q, k, v, causal=True)
    grads = fa.attention_bwd_ref(q, k, v, o, torch.ones_like(o), lse)
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0][0, 0, :3].abs().sum()) == 0.0


# ------------------------------------------------------------ delta sync
def test_aggregator_dedups_seals_and_rejects_late():
    agg = DeltaAggregator(["a", "b", "c"], quorum=2)
    g = lambda x: {"w": torch.full((3,), float(x)), "l": [torch.ones(2) * x]}
    assert agg.offer(GradDelta("a", 0, 4, g(1.0)))
    assert not agg.offer(GradDelta("a", 0, 4, g(1.0)))   # duplicate
    assert not agg.ready(0)
    assert agg.offer(GradDelta("b", 0, 2, g(3.0)))
    assert agg.ready(0) and agg.missing(0) == ["c"]
    mean, n = agg.seal(0)
    assert n == 2
    assert torch.equal(mean["w"], torch.full((3,), 4.0 / 6))
    assert not agg.offer(GradDelta("c", 0, 2, g(9.0)))   # sealed: late
    assert agg.offer(GradDelta("c", 1, 2, g(9.0)))       # next step is open
    with pytest.raises(KeyError):
        agg.seal(5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_aggregated_mean_matches_jax(dtype):
    rng = np.random.default_rng(7)
    contribs = [(h, n, rng.standard_normal((5, 7)).astype(np.float32))
                for h, n in (("a", 3), ("b", 5), ("c", 2))]
    jagg, tagg = JaxAggregator(["a", "b", "c"]), DeltaAggregator(["a", "b", "c"])
    for h, n, x in contribs:
        jagg.offer(JaxDelta(h, 0, n, {"w": jnp.asarray(x, dtype)}))
        tagg.offer(GradDelta(h, 0, n, {"w": torch.tensor(x).to(
            getattr(torch, dtype))}))
    jmean, jn = jagg.seal(0)
    tmean, tn = tagg.seal(0)
    assert jn == tn == 3
    assert tmean["w"].dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(tmean["w"]),
                                  np.asarray(jmean["w"], np.float32))
