"""The port's CUDA kernels (attention, selective scan, clock lattice)
against their plain versions, on a card.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither ``jax`` nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances are those of the CPU tests: 2e-5 in fp32; 2e-2 (prefill) and
3e-2 (decode) in bf16, where the plain version rounds scores and
probabilities to bf16 and the kernel keeps them in fp32; 2e-4 for the
scan (fp32), whose kernel sums over the states in another order; exact
equality for the clock lattice (integers).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.vclock import DenseClock, sort_runs
from repro_torch.kernels import clock_ops
from repro_torch.kernels.clock_ops.kernel import staged as clock_staged

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.mamba_scan import (DISPATCHES as SCANS, mamba_scan,
                                            mamba_scan_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,S,D,window", [(37, 200, 16, None),
                                          (256, 256, 128, 64),
                                          (65, 65, 256, None)])
def test_flash_kernel_matches_plain_on_the_card(cuda, dtype, tol, T, S, D,
                                                window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 4, T, D), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((2, 2, S, D), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((2, 2, S, D), generator=g, device=cuda, dtype=dtype)
    got = flash_attention(q, k, v, causal=True, window=window)
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_decode_kernel_matches_plain_on_the_card(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((4, 32, 128), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((4, 16, 2048, 128), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((4, 16, 2048, 128), generator=g, device=cuda, dtype=dtype)
    lens = torch.tensor([1, 700, 1553, 2048], dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, lens)
    want = decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,D,N", [(1, 1, 64, 16), (2, 37, 96, 8),
                                     (4, 777, 8192, 16), (3, 130, 40, 16),
                                     (2, 50, 24, 3)])
def test_mamba_scan_kernel_matches_plain_on_the_card(cuda, B, T, D, N):
    g = torch.Generator(device=cuda).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    x = normal(B, T, D)
    delta = torch.nn.functional.softplus(normal(B, T, D) - 4.6)
    A = -torch.exp(normal(D, N))
    args = (x, delta, A, normal(B, T, N), normal(B, T, N), normal(D))
    launched = SCANS.kernel_launches
    y, hT = mamba_scan(*args)
    assert SCANS.kernel_launches == launched + 1
    y_want, h_want = mamba_scan_ref(*args)
    assert hT.shape == (B, D, N)
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(hT, h_want, atol=2e-4, rtol=2e-4)


# ------------------------------------------------------------ clock lattice
CLOCK_MODES = (("join", "or", clock_ops.join_ref),
               ("subtract", "andnot", clock_ops.subtract_ref),
               ("intersect", "and", clock_ops.intersect_ref))
TOP, LOW = 2**31 - 1, -2**31


def _clock_rows(rng, n_actors, n_runs, hi):
    """Unsorted, overlapping runs with duplicates and empty slots."""
    s = rng.integers(0, hi, (n_actors, n_runs))
    e = s + rng.integers(-2, max(3, hi // 8), (n_actors, n_runs))
    if n_runs > 3:
        s[:, 3], e[:, 3] = s[:, 1], e[:, 1]
    empty = rng.random((n_actors, n_runs)) < 0.2
    s[empty], e[empty] = 1, 0
    return s.astype(np.int32), np.minimum(e, TOP).astype(np.int32)


def _edge_rows():
    E = (1, 0)
    a = [[(TOP - 10, TOP), (5, 9), E, (TOP - 30, TOP - 25)],
         [(LOW, TOP - 3), E, E, E],
         [(50, 80), (10, 20), (15, 60), (10, 20)],
         [(0, TOP - 5), (10, TOP), (0, TOP), E]]
    b = [[(TOP - 3, TOP), (TOP - 20, TOP - 12), (6, 6)],
         [(LOW, -5), (TOP - 1, TOP), (LOW, LOW)],
         [(70, 90), E, (10, 20)],
         [(0, 0), (TOP, TOP), E]]

    def arrays(rows):
        return (np.array([[r[0] for r in row] for row in rows], np.int64)
                .astype(np.int32),
                np.array([[r[1] for r in row] for row in rows], np.int64)
                .astype(np.int32))
    return (*arrays(a), *arrays(b))


CLOCK_SHAPES = {"ragged": (13, 25, 7, 300),   # A, Ra, Rb, counters below
                "tomb": (1, 2000, 2000, 100_000),  # the bigset tombstone
                "churn": (512, 128, 128, TOP),  # 512 actors of 128 runs
                "wide": (3, 9000, 7000, TOP)}   # rows past shared memory


def _clock_inputs(shape, cuda):
    rng = np.random.default_rng(5)
    if shape == "edge":
        arrays = _edge_rows()
    else:
        n_actors, ra, rb, hi = CLOCK_SHAPES[shape]
        arrays = (*_clock_rows(rng, n_actors, ra, hi),
                  *_clock_rows(rng, n_actors, rb, hi))
    return [torch.from_numpy(x).to(cuda) for x in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["ragged", "edge", "tomb", "churn",
                                   "wide"])
def test_clock_merge_kernel_matches_plain_on_the_card(cuda, shape):
    a_s, a_e, b_s, b_e = _clock_inputs(shape, cuda)
    ra, rb = a_s.shape[1], b_s.shape[1]
    # rows past a block's shared memory take the global-memory route
    assert clock_staged(ra, rb, cuda) == (shape != "wide")
    a, b = DenseClock(a_s, a_e), DenseClock(b_s, b_e)
    merges = clock_ops.DISPATCHES.merge
    for op, mode, ref in CLOCK_MODES:
        # the plain version row by row: its [A, P, P] masks stay small
        want = [torch.cat(x) for x in zip(*(
            ref(a_s[i:i + 1], a_e[i:i + 1], b_s[i:i + 1], b_e[i:i + 1])
            for i in range(a_s.shape[0])))]
        raw = clock_ops.clock_merge_cuda(mode, a_s, a_e, b_s, b_e)
        # the kernel writes the plain version's slots, before any sort
        assert all(torch.equal(g, w) for g, w in zip(raw, want))
        launched = merges.kernel_launches
        got = getattr(clock_ops, op)(a, b)
        assert merges.kernel_launches == launched + 1
        assert all(torch.equal(g, w) for g, w in zip(got, sort_runs(*want)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["ragged", "edge", "tomb", "churn",
                                   "wide"])
def test_clock_popcount_kernel_matches_plain_on_the_card(cuda, shape):
    a_s, a_e, b_s, b_e = _clock_inputs(shape, cuda)
    pops = clock_ops.DISPATCHES.popcount
    for s, e in ((a_s, a_e), (b_s, b_e)):
        launched = pops.kernel_launches
        got = clock_ops.popcount(DenseClock(s, e))
        assert pops.kernel_launches == launched + 1
        assert got.dtype == torch.int32
        assert torch.equal(got, clock_ops.popcount_ref(s, e))
    if shape == "edge":
        assert int(clock_ops.popcount(DenseClock(a_s, a_e))[3]) == -15
