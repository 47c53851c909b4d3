"""The selective scan's backward kernel (``csrc/mamba_scan_bwd.cu``) and the
forward's train variant on a card, against their plain versions.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_mamba_bwd.py

The shapes are those of ``chip_smoke.py``'s backward phase (the
``falcon-mamba-7b`` training shape, ``jamba-1.5-large-398b``'s width, a
ragged T, N = 8 at B = 2), narrow ones (N of 1, 3 and 32, widths that are
not a multiple of a block's 64 channels) and T around a segment's end
(``kernel.bwd_plan``: 15, 16 and 17 steps, where the first segment is one
16-step window; 255, 256 and 257 at falcon's width; B = 3 with eleven
segments), in fp32 and bf16, held with the tolerances of
``chip_smoke.py``'s ``MAMBA_BWD_TOL`` (see :func:`grad_ok`).  The train
variant must leave the serve outputs bit for bit and write the states
entering each 16-step window; two launches of the backward, and two
deterministic ``grad_step``s of the smoke ``falcon-mamba-7b`` and
``jamba-1.5-large-398b``, must agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels.mamba_scan.kernel import (CHUNK, EDGE, bwd_plan,
                                                   edge_states, edges_shape,
                                                   mamba_scan_bwd_cuda,
                                                   mamba_scan_cuda)
from repro_torch.models import build_model
from repro_torch.runtime.ft import deterministic
from repro_torch.tree import leaves, map_tree

NAMES = ("dx", "ddelta", "dA", "dBm", "dCm", "dD")
SHAPES = [(1, 4096, 8192, 16), (1, 4096, 16384, 16), (1, 63, 1024, 16),
          (2, 777, 512, 8), (3, 100, 100, 3), (2, 70, 200, 32),
          (2, 100, 256, 1),
          # T around a segment's end: one 16-step window less, equal, more
          (1, 15, 512, 16), (1, 16, 512, 16), (1, 17, 512, 16),
          (1, 255, 8192, 16), (1, 256, 8192, 16), (1, 257, 8192, 16),
          # several segments at B = 3
          (3, 1000, 512, 16)]
# fp32: rtol 1e-4 above an atol of 1e-5 of the gradient's largest entry
# (at T = 4,096 the plain fp32 version itself misses an absolute 1e-5
# against fp64 where sums reach ~270), and 1e-5 in norm; bf16: rtol
# 1.6e-2 (two bf16 steps) above 1e-3, and 5e-4 in norm
FP32_NORM, BF16_NORM = 1e-5, 5e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def scan_inputs(B, T, D, N, dtype, seed):
    """Inputs on the card as the model draws them (softplus step sizes of
    ~0.01, A = -(1..N) jittered), normal x, B, C, D and dy."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    x = normal(B, T, D)
    delta = torch.nn.functional.softplus(normal(B, T, D) - 4.6)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda").repeat(D, 1)
    A = A * torch.exp(0.1 * normal(D, N))
    Bm, Cm, Dp, dy = normal(B, T, N), normal(B, T, N), normal(D), normal(B, T, D)
    return ((x.to(dtype), delta.to(dtype), A, Bm.to(dtype), Cm.to(dtype), Dp),
            dy.to(dtype))


def grad_ok(g, want, dtype) -> bool:
    """Whether a gradient of the kernel is within the backward's tolerance
    of the plain version's."""
    g, w = g.double(), want.double()
    d = (g - w).abs()
    rel = float(d.norm() / w.norm().clamp_min(1e-30))
    if dtype == torch.float32:
        atol = 1e-5 * float(w.abs().max())
        return bool((d <= atol + 1e-4 * w.abs()).all()) and rel <= FP32_NORM
    return bool((d <= 1e-3 + 1.6e-2 * w.abs()).all()) and rel <= BF16_NORM


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,N", SHAPES)
def test_scan_bwd_kernel_matches_plain_on_the_card(cuda, B, T, D, N, dtype):
    args, dy = scan_inputs(B, T, D, N, dtype, seed=T + N)
    # T is cut into segments wherever it is longer than one window
    assert (bwd_plan(B, T, D, N).n_seg > 1) == (T > EDGE)
    y, hT, edges = mamba_scan_cuda(*args, with_edges=True)
    launched = ms.BWD_DISPATCHES.kernel_launches
    got = ms.mamba_scan_bwd(*args, dy, edges)
    assert ms.BWD_DISPATCHES.kernel_launches == launched + 1
    assert [g.dtype for g in got] == [a.dtype for a in args]
    want = ms.mamba_scan_bwd_ref(*args, dy)
    for name, g, w in zip(NAMES, got, want):
        assert bool(torch.isfinite(g).all()), name
        assert grad_ok(g, w, dtype), name
    again = mamba_scan_bwd_cuda(*args, dy, edges)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, CHUNK - 1, CHUNK, CHUNK + 1, 777])
def test_train_variant_keeps_the_serve_outputs_and_writes_the_edges(
        cuda, T, dtype):
    args, _ = scan_inputs(2, T, 200, 16, dtype, seed=T)
    y0, h0 = mamba_scan_cuda(*args)
    y1, h1, edges = mamba_scan_cuda(*args, with_edges=True)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    # the state entering each window of EDGE steps, [B, ceil(T / 16),
    # ceil(N / 4), D, 4]
    assert edges.shape == edges_shape(2, T, 200, 16) \
        == (2, -(-T // EDGE), 4, 200, 4)
    states = edge_states(edges, 16)
    assert bool((states[:, 0] == 0).all())
    for e in range(1, states.shape[1]):
        _, h = ms.mamba_scan_ref(*(a[:, :e * EDGE].contiguous()
                                   if a.dim() == 3 else a for a in args))
        torch.testing.assert_close(states[:, e], h, atol=2e-4, rtol=2e-4)


@pytest.mark.gpu
def test_function_on_the_card_launches_both_kernels(cuda):
    args, dy = scan_inputs(2, 70, 96, 16, torch.float32, seed=3)
    leaves_ = [a.clone().requires_grad_() for a in args]
    ms.DISPATCHES.reset()
    ms.BWD_DISPATCHES.reset()
    y, _ = ms.mamba_scan(*leaves_)
    y.backward(dy)
    assert ms.DISPATCHES.kernel_launches == ms.DISPATCHES.launches == 1
    assert ms.BWD_DISPATCHES.kernel_launches == ms.BWD_DISPATCHES.launches == 1
    want = ms.mamba_scan_bwd_ref(*args, dy)
    for name, leaf, w in zip(NAMES, leaves_, want):
        assert grad_ok(leaf.grad, w, torch.float32), name


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-1.5-large-398b"])
def test_grad_steps_repeat_bit_for_bit_and_match_the_cpu(cuda, arch):
    cfg = smoke_config(arch)
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, "cuda")
    params = cpu.init(0)
    gparams = map_tree(lambda t: t.to(cuda), params)
    tok = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (4, 65)), dtype=torch.int32)
    want_loss, want = cpu.grad_step(params, {"tokens": tok})
    n_mamba = sum(cfg.layer_kind(i)[0] == "mamba" for i in range(cfg.n_layers))
    ms.BWD_DISPATCHES.reset()
    runs = []
    for _ in range(2):
        with deterministic(cuda):
            runs.append(gpu.grad_step(gparams, {"tokens": tok.to(cuda)}))
    assert ms.BWD_DISPATCHES.kernel_launches == 2 * n_mamba
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    assert float(l0) == pytest.approx(float(want_loss), rel=1e-5)
    for a, b in zip(leaves(g0), leaves(want)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
