"""Mamba's training mode in the port against the JAX package's, on the CPU.

The scan's gradient: the port's plain version (``mamba_scan_bwd_ref``, an
explicit reverse-time recurrence, the formula of the CUDA backward
kernel) is held against ``jax.vjp`` of the JAX ``mamba_scan_ref`` within
2e-4 (the scan's tolerance) and against autograd of the port's own
``mamba_scan_ref`` within 1e-5 (one fp32 recurrence, summed in another
order), at ragged T, N 8 and 16, B 1 and 2.  The wrapper sends a call
under autograd through ``MambaScanFunction`` and counts its backward in
``BWD_DISPATCHES``.  The Mamba block in ``train`` mode and the smoke
``falcon-mamba-7b`` model's loss (rtol 1e-5) and every gradient leaf
(rtol 1e-4, atol 1e-5) agree with the JAX package's from the same
parameters, as ``tests/test_torch_train.py`` holds attention.  The CUDA
kernels run only on a card; ``tests/test_torch_cuda_mamba_bwd.py`` and
``chip_smoke.py`` hold them against the same plain versions there.
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
from repro.kernels.mamba_scan import mamba_scan_ref as jax_scan_ref
from repro.models import build_model as jax_build_model
from repro.models.mamba import init_mamba as jax_init_mamba
from repro.models.mamba import mamba_forward as jax_mamba_forward
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax, tensor_from_numpy, \
    train_state_from_jax
from repro_torch.kernels import mamba_scan as ms_pkg
from repro_torch.kernels.mamba_scan import (MambaScanFunction, mamba_scan,
                                            mamba_scan_bwd,
                                            mamba_scan_bwd_ref,
                                            mamba_scan_ref)
from repro_torch.models import build_model
from repro_torch.models.mamba import mamba_forward
from repro_torch.tree import leaves
from torch_trees import adam_step_at_rounding, assert_trees_close

ARCH = "falcon-mamba-7b"
NAMES = ("x", "delta", "A", "Bm", "Cm", "D")
CASES = [(1, 37, 24, 16), (2, 64, 32, 8), (2, 45, 16, 16), (1, 70, 12, 8)]
IDS = [f"B{b}-T{t}-D{d}-N{n}" for b, t, d, n in CASES]
CPU = torch.device("cpu")


def _inputs(B, T, Dm, N, seed):
    """Seeded numpy inputs drawn as ``tests/test_torch_mamba.py`` draws
    them, and the gradient of ``y``."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, Dm)).astype(np.float32),
            (np.abs(rng.standard_normal((B, T, Dm))) * 0.1).astype(np.float32),
            -(np.abs(rng.standard_normal((Dm, N))) + 0.1).astype(np.float32),
            rng.standard_normal((B, T, N)).astype(np.float32),
            rng.standard_normal((B, T, N)).astype(np.float32),
            rng.standard_normal(Dm).astype(np.float32)), \
        rng.standard_normal((B, T, Dm)).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------- the scan's gradient
@pytest.mark.parametrize("B,T,Dm,N", CASES, ids=IDS)
def test_scan_bwd_ref_matches_jax_grad(B, T, Dm, N):
    args, dy = _inputs(B, T, Dm, N, seed=T + N)
    _, vjp = jax.vjp(lambda *a: jax_scan_ref(*a)[0],
                     *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(dy))
    got = mamba_scan_bwd_ref(*(torch.from_numpy(a) for a in args),
                             torch.from_numpy(dy))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        assert_allclose(_np(g), np.asarray(w), atol=2e-4, rtol=2e-4,
                        err_msg=name)


@pytest.mark.parametrize("B,T,Dm,N", CASES, ids=IDS)
def test_scan_bwd_ref_matches_autograd_of_the_plain_scan(B, T, Dm, N):
    args, dy = _inputs(B, T, Dm, N, seed=2 * T + N)
    leaves_ = [torch.from_numpy(a).requires_grad_() for a in args]
    y, _ = mamba_scan_ref(*leaves_)
    y.backward(torch.from_numpy(dy))
    got = mamba_scan_bwd_ref(*(torch.from_numpy(a) for a in args),
                             torch.from_numpy(dy))
    for name, g, leaf in zip(NAMES, got, leaves_):
        assert_allclose(_np(g), _np(leaf.grad), atol=1e-5, rtol=1e-5,
                        err_msg=name)


def test_scan_bwd_ref_keeps_each_input_type():
    args, dy = _inputs(1, 9, 8, 4, seed=1)
    t = [torch.from_numpy(a) for a in args]
    for i in (0, 1, 3, 4):
        t[i] = t[i].to(torch.bfloat16)
    got = mamba_scan_bwd_ref(*t, torch.from_numpy(dy).to(torch.bfloat16))
    assert [g.dtype for g in got] == [a.dtype for a in t]


# ----------------------------------------------------------- the wrapper
def test_wrapper_under_autograd_runs_the_function_and_counts_it():
    args, dy = _inputs(2, 33, 16, 8, seed=5)
    ms_pkg.DISPATCHES.reset()
    ms_pkg.BWD_DISPATCHES.reset()
    leaves_ = [torch.from_numpy(a).requires_grad_() for a in args]
    y, hT = mamba_scan(*leaves_)
    assert y.grad_fn is not None and y.grad_fn.name().startswith(
        MambaScanFunction.__name__)
    assert not hT.requires_grad  # h_T takes no gradient
    y.backward(torch.from_numpy(dy))
    want = mamba_scan_bwd_ref(*(torch.from_numpy(a) for a in args),
                              torch.from_numpy(dy))
    for name, leaf, w in zip(NAMES, leaves_, want):
        assert torch.equal(leaf.grad, w), name
    assert vars(ms_pkg.DISPATCHES) == dict(launches=1, rows=2 * 16,
                                           kernel_launches=0)
    assert vars(ms_pkg.BWD_DISPATCHES) == dict(launches=1, rows=2 * 16,
                                               kernel_launches=0)
    # without autograd: the serve call, no Function and no backward
    with torch.no_grad():
        y2, h2 = mamba_scan(*leaves_)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())
    assert torch.equal(h2, hT)
    assert ms_pkg.DISPATCHES.launches == 2
    assert ms_pkg.BWD_DISPATCHES.launches == 1


@pytest.mark.parametrize("bad", ["shape", "dtype", "contig"])
def test_bwd_wrapper_checks_dy(bad):
    args, dy = _inputs(1, 6, 8, 4, seed=2)
    dy = torch.from_numpy(dy)
    if bad == "shape":
        dy = dy[:, :5].contiguous()
    elif bad == "dtype":
        dy = dy.to(torch.bfloat16)
    else:
        dy = torch.zeros((1, 8, 6)).transpose(1, 2)
    with pytest.raises(ValueError, match="dy"):
        mamba_scan_bwd(*(torch.from_numpy(a) for a in args), dy)


def test_bwd_wrapper_on_cuda_launches_the_kernel_or_raises():
    # fake CUDA tensors (shape, dtype and device only): the backward must go
    # to the kernel, which cannot be built or launched here, and raise; it
    # needs the train variant's edges, and never runs the plain version
    from torch._subclasses.fake_tensor import FakeTensorMode
    ms_pkg.BWD_DISPATCHES.reset()
    with FakeTensorMode():
        x = torch.zeros((1, 40, 8), device="cuda")
        A = torch.zeros((8, 4), device="cuda")
        Bm = torch.zeros((1, 40, 4), device="cuda")
        Dp = torch.zeros(8, device="cuda")
        with pytest.raises(ValueError, match="edges"):
            mamba_scan_bwd(x, x.clone(), A, Bm, Bm.clone(), Dp, x.clone())
        with pytest.raises(ValueError, match="edges"):
            mamba_scan_bwd(x, x.clone(), A, Bm, Bm.clone(), Dp, x.clone(),
                           torch.zeros((1, 8, 2, 4), device="cuda"))
        # [B, ceil(T / 16), ceil(N / 4), D, 4]: the state entering each
        # window of 16 steps
        edges = torch.zeros((1, 3, 1, 8, 4), device="cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            mamba_scan_bwd(x, x.clone(), A, Bm, Bm.clone(), Dp, x.clone(),
                           edges)
    assert ms_pkg.BWD_DISPATCHES.kernel_launches == 0


def test_backward_module_builds_nothing_on_import():
    from repro_torch.kernels.mamba_scan import kernel as mk
    assert mk.bwd_library.cache_info().currsize == 0
    assert mk.BWD_SOURCE.is_file() and mk.BWD_SOURCE.suffix == ".cu"
    assert [mk.n_edges(t) for t in (1, 32, 33, 4096)] == [1, 2, 3, 256]


# --------------------------------------------------------- the Mamba block
@pytest.mark.parametrize("T", [5, 40])
def test_block_train_mode_and_its_gradients_match_jax(T):
    jcfg, tcfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    jp = jax_init_mamba(jax.random.key(1), jcfg, jnp.float32)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T, tcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal((2, T, tcfg.d_model)).astype(np.float32)

    def jloss(p, x):
        out, cache = jax_mamba_forward(p, jcfg, x, mode="train")
        assert cache is None
        return jnp.sum(out * cot), out
    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    tp = {k: tensor_from_numpy(np.asarray(v), CPU).requires_grad_()
          for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out_t, cache = mamba_forward(tp, tcfg, xt, mode="train")
    assert cache is None
    assert_allclose(_np(out_t), np.asarray(out_j), atol=1e-4, rtol=1e-4)
    (out_t * torch.from_numpy(cot)).sum().backward()
    assert_allclose(_np(xt.grad), np.asarray(gx_j), atol=1e-5, rtol=1e-4)
    for name, leaf in tp.items():
        assert leaf.grad.dtype == leaf.dtype, name
        assert_allclose(_np(leaf.grad), np.asarray(gp_j[name]), atol=1e-5,
                        rtol=1e-4, err_msg=name)


# ------------------------------------------------------ the whole model
@functools.lru_cache(maxsize=None)
def _jax_side(items):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **dict(items))
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.key(0))
    return jcfg, jmodel, jstate, jax.tree.map(np.asarray, jstate)


def _both(**kw):
    jcfg, jmodel, jstate, tree = _jax_side(tuple(sorted(kw.items())))
    tcfg = dataclasses.replace(smoke_config(ARCH), **kw)
    assert vars(jcfg) == vars(tcfg)
    return (jcfg, tcfg, jmodel, jstate, build_model(tcfg, "cpu"),
            train_state_from_jax(tcfg, tree, "cpu"))


def _tokens(cfg, B=4, T=33, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _assert_trees_close(got, want_jax, cfg, **tol):
    want = params_from_jax(cfg, jax.tree.map(np.asarray, want_jax), "cpu")
    assert_trees_close(got, want, **tol)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_loss_and_every_gradient_leaf_match_jax(scan_layers):
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both(
        scan_layers=scan_layers)
    tok = _tokens(tcfg)
    jl, jg = jmodel.grad_step(jstate.params, {"tokens": jnp.asarray(tok)})
    ms_pkg.BWD_DISPATCHES.reset()
    tl, tg = tmodel.grad_step(tstate.params, {"tokens": torch.from_numpy(tok)})
    assert ms_pkg.BWD_DISPATCHES.launches == tcfg.n_layers
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _assert_trees_close(tg, jg, tcfg, rtol=1e-4, atol=1e-5)


def test_remat_runs_the_scan_twice_and_keeps_gradients():
    cfg = smoke_config(ARCH)
    params = build_model(cfg, "cpu").init(0)
    tok = torch.from_numpy(_tokens(cfg))
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
        ms_pkg.DISPATCHES.reset()
        ms_pkg.BWD_DISPATCHES.reset()
        out[remat] = model.grad_step(params, {"tokens": tok})
        assert ms_pkg.DISPATCHES.launches == cfg.n_layers * (1 + remat)
        assert ms_pkg.BWD_DISPATCHES.launches == cfg.n_layers
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(leaves(out[True][1]), leaves(out[False][1])):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)


def test_two_train_steps_match_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both()
    # the first step's gradients: where an entry's is at rounding level on
    # both sides, the two AdamW steps may differ (adam_step_at_rounding)
    tok = _tokens(tcfg, seed=20)
    _, jg = jmodel.grad_step(jstate.params, {"tokens": jnp.asarray(tok)})
    _, tg = tmodel.grad_step(tstate.params, {"tokens": torch.from_numpy(tok)})
    first_step = adam_step_at_rounding(
        tg, params_from_jax(tcfg, jax.tree.map(np.asarray, jg), "cpu"),
        tmodel.opt_cfg.lr, grad_atol=1e-5)
    jstep = jax.jit(jmodel.train_step)
    for step in range(2):
        tok = _tokens(tcfg, seed=20 + step)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
        tstate, tm = tmodel.train_step(tstate,
                                       {"tokens": torch.from_numpy(tok)})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _assert_trees_close(tstate.params, jstate.params, tcfg, rtol=1e-4,
                        atol=1e-5, excuse=first_step)
    _assert_trees_close(tstate.opt["mu"], jstate.opt["mu"], tcfg, rtol=1e-4,
                        atol=1e-6)


def test_gradients_reach_every_mamba_leaf():
    cfg = smoke_config(ARCH)
    model = build_model(cfg, "cpu")
    _, grads = model.grad_step(model.init(0),
                               {"tokens": torch.from_numpy(_tokens(cfg))})
    for layer in grads["layers"]:
        for name, g in layer["mamba"].items():
            assert float(g.abs().sum()) > 0, name
