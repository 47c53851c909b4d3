"""The port's selective scan and Mamba block against the JAX package's, on
the CPU.

The scan's plain version (and its wrapper, on CPU tensors) is held against
the JAX ``mamba_scan_ref`` (``y`` and the final state) and the Pallas
kernel in interpret mode (``y``) at the cases of ``tests/test_kernels.py``
and at ragged T, within 2e-4, the scan tolerance of the JAX package's
kernel tests; ``mamba_step`` within 1e-5.  bf16 inputs (the Pallas
kernel casts them inside its body, as the port's kernel does) give ``y``
in bf16 within 2e-2 (both round one fp32 sum) and the final state in fp32
within 2e-4.  The Mamba block runs prefill and decode on the smoke
``falcon-mamba-7b`` beside the JAX block with the same weights, within
1e-4 in fp32, caches compared, and prefill in bf16 within 2e-2 (the state
within 2e-4).  The CUDA kernel runs
only on a card; ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``
hold it against the same plain version there.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from numpy.testing import assert_allclose

from repro.configs import smoke_config as jax_smoke_config
from repro.kernels.mamba_scan import (mamba_scan_pallas,
                                      mamba_scan_ref as jax_scan_ref,
                                      mamba_step_ref as jax_step_ref)
from repro.models.mamba import init_mamba as jax_init_mamba
from repro.models.mamba import mamba_forward as jax_mamba_forward
from repro_torch.configs import smoke_config
from repro_torch.interop import tensor_from_numpy
from repro_torch.kernels import mamba_scan as ms_pkg
from repro_torch.kernels.mamba_scan import (mamba_scan, mamba_scan_ref,
                                            mamba_step, mamba_step_ref)
from repro_torch.models.mamba import init_mamba_cache, mamba_forward

SCAN_TOL = dict(atol=2e-4, rtol=2e-4)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK_TOL = dict(atol=1e-4, rtol=1e-4)
CPU = torch.device("cpu")


def _scan_inputs(rng, B, T, Dm, N):
    """Seeded numpy inputs drawn as ``tests/test_kernels.py`` draws them."""
    return (rng.standard_normal((B, T, Dm)).astype(np.float32),
            (np.abs(rng.standard_normal((B, T, Dm))) * 0.1).astype(np.float32),
            -(np.abs(rng.standard_normal((Dm, N))) + 0.1).astype(np.float32),
            rng.standard_normal((B, T, N)).astype(np.float32),
            rng.standard_normal((B, T, N)).astype(np.float32),
            rng.standard_normal(Dm).astype(np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------- the scan
@pytest.mark.parametrize("B,T,Dm,N,chunk,block_d", [
    (1, 64, 32, 8, 32, 32),
    (2, 128, 64, 16, 64, 32),
    (1, 96, 48, 16, 32, 16),
])
def test_scan_plain_matches_jax_ref_and_pallas(B, T, Dm, N, chunk, block_d):
    args = _scan_inputs(np.random.default_rng(T + Dm), B, T, Dm, N)
    y, hT = mamba_scan_ref(*_t(args))
    y_want, h_want = jax_scan_ref(*_j(args))
    assert y.shape == (B, T, Dm) and hT.shape == (B, Dm, N)
    assert y.dtype == torch.float32 and hT.dtype == torch.float32
    assert_allclose(y.numpy(), np.asarray(y_want), **SCAN_TOL)
    assert_allclose(hT.numpy(), np.asarray(h_want), **SCAN_TOL)
    y_pallas = mamba_scan_pallas(*_j(args), chunk=chunk, block_d=block_d,
                                 interpret=True)
    assert_allclose(y.numpy(), np.asarray(y_pallas), **SCAN_TOL)
    # the wrapper runs the plain version on CPU tensors
    y2, h2 = mamba_scan(*_t(args))
    assert torch.equal(y2, y) and torch.equal(h2, hT)


@pytest.mark.parametrize("T", [1, 3, 37])
def test_scan_ragged_T_matches_jax_ref(T):
    # the Pallas kernel needs T % chunk == 0; the port's scan takes any T
    args = _scan_inputs(np.random.default_rng(T), 2, T, 24, 16)
    y, hT = mamba_scan(*_t(args))
    y_want, h_want = jax_scan_ref(*_j(args))
    assert_allclose(y.numpy(), np.asarray(y_want), **SCAN_TOL)
    assert_allclose(hT.numpy(), np.asarray(h_want), **SCAN_TOL)


def _bf16(arrays):
    """bf16 tensors of the fp32 ``arrays`` and the same values in fp32
    numpy, exact, for the JAX side to cast back."""
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return ts, [t.float().numpy() for t in ts]


@pytest.mark.parametrize("B,T,Dm,N", [(1, 37, 24, 16), (2, 64, 32, 8),
                                      (3, 5, 16, 3)])
def test_scan_takes_bf16_and_matches_jax_ref(B, T, Dm, N):
    x, delta, A, Bm, Cm, Dp = _scan_inputs(np.random.default_rng(B * T),
                                           B, T, Dm, N)
    (xt, dt, bt, ct), (xn, dn, bn, cn) = _bf16([x, delta, Bm, Cm])
    y, hT = mamba_scan(xt, dt, torch.from_numpy(A), bt, ct,
                       torch.from_numpy(Dp))
    assert y.dtype == torch.bfloat16 and hT.dtype == torch.float32
    bf = jnp.bfloat16
    y_want, h_want = jax_scan_ref(
        jnp.asarray(xn).astype(bf), jnp.asarray(dn).astype(bf),
        jnp.asarray(A), jnp.asarray(bn).astype(bf),
        jnp.asarray(cn).astype(bf), jnp.asarray(Dp))
    assert y_want.dtype == bf
    assert_allclose(y.float().numpy(), np.asarray(y_want, np.float32),
                    atol=2e-2, rtol=2e-2)
    assert_allclose(hT.numpy(), np.asarray(h_want), **SCAN_TOL)


def test_scan_from_a_given_state_matches_jax_ref():
    rng = np.random.default_rng(4)
    args = _scan_inputs(rng, 2, 9, 16, 8)
    h0 = rng.standard_normal((2, 16, 8)).astype(np.float32)
    y, hT = mamba_scan_ref(*_t(args), h0=torch.from_numpy(h0))
    y_want, h_want = jax_scan_ref(*_j(args), h0=jnp.asarray(h0))
    assert_allclose(y.numpy(), np.asarray(y_want), **SCAN_TOL)
    assert_allclose(hT.numpy(), np.asarray(h_want), **SCAN_TOL)


def test_step_matches_jax():
    rng = np.random.default_rng(5)
    B, Dm, N = 3, 32, 16
    x, delta, A, Bm, Cm, Dp = _scan_inputs(rng, B, 1, Dm, N)
    h = rng.standard_normal((B, Dm, N)).astype(np.float32)
    step_args = [x[:, 0], delta[:, 0], A, Bm[:, 0], Cm[:, 0], Dp, h]
    y, h1 = mamba_step(*_t(step_args))
    y_want, h_want = jax_step_ref(*_j(step_args))
    assert_allclose(y.numpy(), np.asarray(y_want), **STEP_TOL)
    assert_allclose(h1.numpy(), np.asarray(h_want), **STEP_TOL)


def test_step_continues_scan():
    """A decode step after a prefill scan equals one longer scan."""
    B, T, Dm, N = 1, 32, 16, 8
    x, delta, A, Bm, Cm, Dp = _t(_scan_inputs(np.random.default_rng(6),
                                              B, T + 1, Dm, N))
    y_full, h_full = mamba_scan(x, delta, A, Bm, Cm, Dp)
    _, h = mamba_scan(x[:, :T].contiguous(), delta[:, :T].contiguous(), A,
                      Bm[:, :T].contiguous(), Cm[:, :T].contiguous(), Dp)
    y_step, h_step = mamba_step_ref(x[:, T], delta[:, T], A, Bm[:, T],
                                    Cm[:, T], Dp, h)
    assert_allclose(y_step.numpy(), y_full[:, T].numpy(), **STEP_TOL)
    assert_allclose(h_step.numpy(), h_full.numpy(), **STEP_TOL)


# --------------------------------------------------------------- the wrapper
def test_wrapper_counts_cpu_calls_but_no_kernel_launch():
    args = _t(_scan_inputs(np.random.default_rng(7), 2, 5, 12, 4))
    ms_pkg.DISPATCHES.reset()
    by_dtype = dict(ms_pkg.DTYPE_LAUNCHES)
    mamba_scan(*args)
    mamba_scan(*(t.to(torch.bfloat16) if t.dim() == 3 else t for t in args))
    assert vars(ms_pkg.DISPATCHES) == dict(launches=2, rows=2 * 2 * 12,
                                           kernel_launches=0)
    assert ms_pkg.DTYPE_LAUNCHES == by_dtype  # kernel launches only


@pytest.mark.parametrize("bad", ["dtype", "contig", "shape", "A", "D", "T0",
                                 "device"])
def test_wrapper_checks_its_arguments(bad):
    x, delta, A, Bm, Cm, Dp = _t(_scan_inputs(np.random.default_rng(8),
                                              1, 6, 8, 4))
    if bad == "dtype":
        x = x.double()
    elif bad == "contig":
        Bm = torch.zeros((1, 4, 6)).transpose(1, 2)
    elif bad == "shape":
        delta = delta[:, :5].contiguous()
    elif bad == "A":
        A = A[:, :3].contiguous()
    elif bad == "D":
        Dp = Dp[:7].contiguous()
    elif bad == "T0":
        x, delta = x[:, :0], delta[:, :0]
        Bm, Cm = Bm[:, :0], Cm[:, :0]
    elif bad == "device":
        # a meta call is the dry run's (no launch); mixed devices still raise
        x = x.to("meta")
    with pytest.raises((TypeError, ValueError)):
        mamba_scan(x, delta, A, Bm, Cm, Dp)


@pytest.mark.parametrize("x_dtype,bad,bad_dtype", [
    (torch.float32, "delta", torch.bfloat16),
    (torch.bfloat16, "Bm", torch.float32),
    (torch.bfloat16, "Cm", torch.float16),
    (torch.bfloat16, "A", torch.bfloat16),
    (torch.float32, "D", torch.float64),
    (torch.float16, None, None),
])
def test_wrapper_rejects_mixed_and_other_dtypes(x_dtype, bad, bad_dtype):
    # x, delta, Bm and Cm share fp32 or bf16; A and D stay fp32
    names = ("x", "delta", "A", "Bm", "Cm", "D")
    args = dict(zip(names, _t(_scan_inputs(np.random.default_rng(11),
                                           1, 4, 8, 4))))
    for nm in ("x", "delta", "Bm", "Cm"):
        args[nm] = args[nm].to(x_dtype)
    if bad:
        args[bad] = args[bad].to(bad_dtype)
    ms_pkg.DISPATCHES.reset()
    with pytest.raises(TypeError):
        mamba_scan(*(args[nm] for nm in names))
    assert ms_pkg.DISPATCHES.launches == 0


def test_wrapper_on_cuda_launches_the_kernel_or_raises():
    # CUDA tensors without a card (fake tensors carry only shape, dtype and
    # device): the wrapper must go to the kernel, which cannot be built or
    # launched here, and raise (torch raises AssertionError where it has no
    # CUDA); it never runs the plain version instead
    from torch._subclasses.fake_tensor import FakeTensorMode
    ms_pkg.DISPATCHES.reset()
    with FakeTensorMode():
        x = torch.zeros((1, 4, 8), device="cuda")
        A = torch.zeros((8, 4), device="cuda")
        Bm = torch.zeros((1, 4, 4), device="cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            mamba_scan(x, x.clone(), A, Bm, Bm.clone(),
                       torch.zeros(8, device="cuda"))
        big = torch.zeros((8, 33), device="cuda")
        with pytest.raises(ValueError, match="N <= 32"):
            mamba_scan(x, x.clone(), big, torch.zeros((1, 4, 33), device="cuda"),
                       torch.zeros((1, 4, 33), device="cuda"),
                       torch.zeros(8, device="cuda"))
    assert ms_pkg.DISPATCHES.kernel_launches == 0


def test_kernel_module_builds_nothing_on_import():
    from repro_torch.kernels.mamba_scan import kernel as mk
    assert mk.library.cache_info().currsize == 0
    assert mk.SOURCE.is_file() and mk.SOURCE.suffix == ".cu"


# ----------------------------------------------------------- the Mamba block
def _block(seed=0):
    jcfg = jax_smoke_config("falcon-mamba-7b")
    tcfg = smoke_config("falcon-mamba-7b")
    jp = jax_init_mamba(jax.random.key(seed), jcfg, jnp.float32)
    tp = {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def test_init_mamba_shapes_and_dtypes_match_jax():
    from repro_torch.models.mamba import init_mamba
    jcfg, tcfg, jp, _ = _block()
    jb = jax_init_mamba(jax.random.key(0), jcfg, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    tb = init_mamba(gen, tcfg, torch.bfloat16)
    assert set(tb) == set(jb)
    for name, leaf in jb.items():
        assert tuple(tb[name].shape) == leaf.shape, name
        want = torch.float32 if leaf.dtype == jnp.float32 else torch.bfloat16
        assert tb[name].dtype == want, name
    # the deterministic leaves agree (A_log to the last bit of a log)
    for name in ("A_log", "Dp", "conv_b", "dt_b"):
        assert_allclose(tb[name].float().numpy(),
                        np.asarray(jb[name], np.float32), rtol=1e-6,
                        err_msg=name)


@pytest.mark.parametrize("T", [2, 12])
def test_block_prefill_and_decode_match_jax(T):
    jcfg, tcfg, jp, tp = _block()
    rng = np.random.default_rng(9)
    B = 2
    x = rng.standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    out_j, cache_j = jax_mamba_forward(jp, jcfg, jnp.asarray(x), mode="prefill")
    out_t, cache_t = mamba_forward(tp, tcfg, torch.from_numpy(x),
                                   mode="prefill")
    assert_allclose(out_t.numpy(), np.asarray(out_j), **BLOCK_TOL)
    # prefill keeps min(T, conv - 1) rows of history
    assert tuple(cache_t["conv"].shape) == cache_j["conv"].shape == \
        (B, min(T, tcfg.ssm_conv - 1), tcfg.d_inner)
    for name in ("conv", "h"):
        assert_allclose(cache_t[name].numpy(), np.asarray(cache_j[name]),
                        **BLOCK_TOL)
    if T < tcfg.ssm_conv - 1:
        return  # decode reads a full window: the engine's splice pads it

    for step in range(4):
        x1 = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
        out_j, cache_j = jax_mamba_forward(jp, jcfg, jnp.asarray(x1),
                                           mode="decode", cache=cache_j)
        out_t, new = mamba_forward(tp, tcfg, torch.from_numpy(x1),
                                   mode="decode", cache=cache_t)
        assert new is cache_t  # updated in place
        assert_allclose(out_t.numpy(), np.asarray(out_j), **BLOCK_TOL)
        for name in ("conv", "h"):
            assert_allclose(cache_t[name].numpy(), np.asarray(cache_j[name]),
                            err_msg=f"step {step} {name}", **BLOCK_TOL)


@pytest.mark.parametrize("T", [5, 33])
def test_block_bf16_prefill_matches_jax(T):
    # the port hands the bf16 activations to the scan as they are; the JAX
    # block casts them to fp32 around its scan.  Its bf16 silu rounds
    # other than torch's (by one bf16 step in some of u), so the state is
    # held against the JAX block's scan of the port block's own
    # activations, and the output against the whole JAX block
    from repro_torch.models.mamba import _causal_conv, _ssm_inputs
    jcfg = jax_smoke_config("falcon-mamba-7b")
    tcfg = smoke_config("falcon-mamba-7b")
    jp = jax_init_mamba(jax.random.key(3), jcfg, jnp.bfloat16)
    tp = {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in jp.items()}
    assert tp["in_proj"].dtype == torch.bfloat16
    assert tp["A_log"].dtype == tp["Dp"].dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, T, tcfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    out_j, cache_j = jax_mamba_forward(
        jp, jcfg, jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        mode="prefill")
    ms_pkg.DISPATCHES.reset()
    out_t, cache_t = mamba_forward(tp, tcfg, x, mode="prefill")
    assert ms_pkg.DISPATCHES.launches == 1
    assert out_t.dtype == torch.bfloat16 and cache_t["h"].dtype == torch.float32
    assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32),
                    atol=2e-2, rtol=2e-2)
    xi = torch.chunk(x @ tp["in_proj"], 2, dim=-1)[0]
    u = torch.nn.functional.silu(_causal_conv(xi, tp["conv_w"], tp["conv_b"]))
    delta, Bm, Cm, A = _ssm_inputs(tp, tcfg, u)
    assert u.dtype == delta.dtype == Bm.dtype == torch.bfloat16
    _, h_want = jax_scan_ref(*(jnp.asarray(t.float().numpy()) for t in
                               (u, delta, A, Bm, Cm, tp["Dp"])))
    assert_allclose(cache_t["h"].numpy(), np.asarray(h_want), **SCAN_TOL)


def test_block_decode_writes_the_given_cache_in_place():
    _, tcfg, _, tp = _block()
    cache = init_mamba_cache(tcfg, 2, torch.float32, CPU)
    conv, h = cache["conv"], cache["h"]
    x1 = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 1, tcfg.d_model)).astype(np.float32))
    mamba_forward(tp, tcfg, x1, mode="decode", cache=cache)
    assert cache["conv"] is conv and cache["h"] is h
    assert conv[:, -1].abs().sum() > 0 and h.abs().sum() > 0
    assert h.dtype == torch.float32

