"""The port's CUDA kernels (attention, selective scan, dot-seen, clock
lattice) against their plain versions, on a card: among them both routes
of prefill attention (the bf16 tensor-core kernel and the SIMT kernel),
non-causal attention at whisper-tiny's encoder and cross-attention shapes
(T < S, T = 1 and T = S at S = 1,500), the split-KV decode kernels at
cache lengths on either side of a split edge, the scan in fp32 and bf16 on either side of its chunk, ``dot_seen``
on either side of a warp's stride and of its shared-memory staging, the
clock merge on rows that are canonical already, that need its sort and
that coalesce into one run, popcount on rows that do not start on 16
bytes, and every wrapper replayed in a CUDA graph.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither ``jax`` nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

The attention backward (``flash_attention_bwd.cu``) is held against its
plain version from the same forward output and log-sum-exps (rtol 1e-4 /
atol 1e-5 in fp32 on the SIMT route; in bf16, on the tensor-core route,
rtol 1.6e-2 / atol 1e-3, two bf16 steps of each entry, and 1e-3 of each
gradient's norm), causal or not (whisper-tiny's encoder and its
cross-attention at 448 against 1,500), windowed, with T above or below S and at
the training path's 24 / 8 grouping over several key tiles, for
bit-identical repeats,
and inside the model: gradients reach ``wq`` / ``wk`` / ``wv`` on the
card, and one ``train_step`` of the smoke ``minitron-4b`` on cuda matches
the cpu's.

Tolerances are those of the CPU tests: 2e-5 in fp32; 2e-2 (prefill) and
3e-2 (decode) in bf16, where the plain version rounds scores and
probabilities to bf16 and the kernel keeps them in fp32; 2e-4 for the
scan in fp32 and for its final state from bf16 inputs, whose kernel sums
over the states in another order, and 2e-2 for its bf16 ``y``, rounded
once from those sums; exact equality for ``dot_seen`` and the clock
lattice (booleans, integers).
"""
import collections

import numpy as np
import pytest
import torch

from repro_torch.core.vclock import DenseClock, sort_runs
from repro_torch.kernels import clock_ops
from repro_torch.kernels.clock_ops.kernel import staged as clock_staged

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention.kernel import (
    LAUNCHES as DECODE_LAUNCHES, Launch as DecodeLaunch, plan_splits)
from repro_torch.kernels.flash_attention import (BWD_DISPATCHES,
                                                 BWD_ROUTE_LAUNCHES,
                                                 ROUTE_LAUNCHES,
                                                 attention_bwd_ref,
                                                 attention_lse_ref,
                                                 attention_ref,
                                                 flash_attention,
                                                 flash_bwd_route, flash_route)
from repro_torch.kernels.dot_seen import (DISPATCHES as DOTS, dot_seen,
                                          dot_seen_ref)
from repro_torch.kernels.dot_seen.kernel import plan as dot_seen_plan
from repro_torch.kernels.mamba_scan import (DISPATCHES as SCANS,
                                            DTYPE_LAUNCHES, mamba_scan,
                                            mamba_scan_ref)
from repro_torch.kernels.mamba_scan.kernel import CHUNK


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
                                          (65, 65, 256, None),
                                          (50, 70, 40, 20)])
def test_flash_kernel_matches_plain_on_the_card(cuda, dtype, tol, T, S, D,
                                                window):
    # fp32 and bf16 at D = 40 take the SIMT kernel, bf16 at D % 16 == 0
    # the tensor-core one
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 4, T, D), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((2, 2, S, D), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((2, 2, S, D), generator=g, device=cuda, dtype=dtype)
    route = flash_route(dtype, D)
    launched = ROUTE_LAUNCHES[route]
    got = flash_attention(q, k, v, causal=True, window=window)
    assert ROUTE_LAUNCHES[route] == launched + 1
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,S", [
    pytest.param(2, 448, 1500, id="cross-T-under-S"),
    pytest.param(4, 1, 1500, id="cross-T1"),
    pytest.param(1, 1500, 1500, id="encoder"),
    pytest.param(3, 37, 200, id="T-under-S-short"),
])
def test_flash_kernel_not_causal_matches_plain(cuda, dtype, tol, B, T, S):
    # whisper-tiny's encoder (T = S = 1,500) and cross-attention (T < S,
    # and T = 1 in decode, against 1,500 = 23 x 64 + 28 encoder positions:
    # a ragged last key tile); 6 heads of 64, fp32 on the SIMT route and
    # bf16 on the tensor cores, where a T = 1 block has one live row
    g = torch.Generator(device=cuda).manual_seed(B * 10_000 + T)
    q = _normal(g, (B, 6, T, 64), dtype, cuda)
    k = _normal(g, (B, 6, S, 64), dtype, cuda)
    v = _normal(g, (B, 6, S, 64), dtype, cuda)
    route = flash_route(dtype, 64)
    assert route == ("tc" if dtype == torch.bfloat16 else "simt")
    launched = ROUTE_LAUNCHES[route]
    got = flash_attention(q, k, v, causal=False)
    assert ROUTE_LAUNCHES[route] == launched + 1
    want = attention_ref(q, k, v, causal=False)
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


def _normal(g, shape, dtype, cuda):
    return torch.randn(shape, generator=g, device=cuda, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 1, 64, 1024])
@pytest.mark.parametrize("T,S", [(1, 1), (4, 9), (63, 63), (65, 200),
                                 (777, 777), (100, 60)])
@pytest.mark.parametrize("D", [64, 128, 256, 80])
def test_flash_tensor_core_route_matches_plain(cuda, D, T, S, window, G):
    # bf16 with D % 16 == 0 takes the TMA + wgmma kernel (D = 80 padded in
    # shared memory up to 128); T > S leaves rows that see no key, which
    # give 0
    g = torch.Generator(device=cuda).manual_seed(T * 7 + S)
    q = _normal(g, (1, 2 * G, T, D), torch.bfloat16, cuda)
    k = _normal(g, (1, 2, S, D), torch.bfloat16, cuda)
    v = _normal(g, (1, 2, S, D), torch.bfloat16, cuda)
    launched = ROUTE_LAUNCHES["tc"]
    got = flash_attention(q, k, v, causal=True, window=window)
    assert ROUTE_LAUNCHES["tc"] == launched + 1
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    if T > S:
        assert torch.all(got[:, :, :T - S] == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, "split-edge"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 8, 12])
def test_decode_split_route_matches_plain(cuda, G, D, dtype, tol, window):
    B, Hkv, S = 6, 2, 640
    L, n_splits = plan_splits(S, Hkv, B)
    assert n_splits > 2
    # empty, one slot, either side of a split edge, a full cache
    lens = torch.tensor([0, 1, L - 1, L, L + 1, S], dtype=torch.int32,
                        device=cuda)
    # a window of 100 slots that crosses a split edge in the longer rows
    w = 100 if window else None
    g = torch.Generator(device=cuda).manual_seed(G * 1000 + D)
    q = _normal(g, (B, G * Hkv, D), dtype, cuda)
    k = _normal(g, (B, Hkv, S, D), dtype, cuda)
    v = _normal(g, (B, Hkv, S, D), dtype, cuda)
    before = collections.Counter(DECODE_LAUNCHES)
    got = decode_attention(q, k, v, lens, window=w)
    # a group above 8 (mistral-large-123b's 12) is cut into two chunks of
    # blocks, 6 heads each
    n_chunks = 2 if G > 8 else 1
    assert DECODE_LAUNCHES - before == {DecodeLaunch(
        grid=(n_splits, Hkv * n_chunks, B),
        gmax=2 if G <= 2 else 4 if G <= 4 else 8,
        chunk_heads=-(-G // n_chunks), n_chunks=n_chunks): 1}
    want = decode_attention_ref(q, k, v, lens, window=w)
    # a row with no valid slot gives 0 (the plain version averages them all)
    assert torch.all(got[0] == 0)
    torch.testing.assert_close(got[1:].float(), want[1:].float(), atol=tol,
                               rtol=tol)


@pytest.mark.gpu
def test_attention_wrappers_replay_in_a_cuda_graph(cuda):
    # the TMA descriptors and the split plan are fixed at capture; new
    # inputs and new cache lengths in the captured tensors give the plain
    # result on replay, with no host sync inside the step
    g = torch.Generator(device=cuda).manual_seed(3)
    bf = torch.bfloat16
    q = _normal(g, (1, 4, 300, 128), bf, cuda)
    k = _normal(g, (1, 2, 300, 128), bf, cuda)
    v = _normal(g, (1, 2, 300, 128), bf, cuda)
    dq = _normal(g, (4, 8, 128), bf, cuda)
    dk = _normal(g, (4, 4, 1024, 128), bf, cuda)
    dv = _normal(g, (4, 4, 1024, 128), bf, cuda)
    lens = torch.tensor([5, 300, 1024, 77], dtype=torch.int32, device=cuda)

    def step():
        return (flash_attention(q, k, v, causal=True, window=64),
                decode_attention(dq, dk, dv, lens))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        flash_out, decode_out = step()
    for new_lens in ([1, 2, 3, 4], [1024, 1023, 513, 256]):
        for t in (q, k, v, dq, dk, dv):
            t.copy_(_normal(g, t.shape, bf, cuda))
        lens.copy_(torch.tensor(new_lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(
            flash_out.float(),
            attention_ref(q, k, v, causal=True, window=64).float(),
            atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(
            decode_out.float(),
            decode_attention_ref(dq, dk, dv, lens).float(),
            atol=3e-2, rtol=3e-2)


def _scan_inputs(g, B, T, D, N, dtype, cuda):
    """x, delta, B and C in ``dtype``; A and D in fp32."""
    x = _normal(g, (B, T, D), torch.float32, cuda)
    delta = torch.nn.functional.softplus(
        _normal(g, (B, T, D), torch.float32, cuda) - 4.6)
    A = -torch.exp(_normal(g, (D, N), torch.float32, cuda))
    Bm = _normal(g, (B, T, N), torch.float32, cuda)
    Cm = _normal(g, (B, T, N), torch.float32, cuda)
    return (x.to(dtype), delta.to(dtype), A, Bm.to(dtype), Cm.to(dtype),
            _normal(g, (D,), torch.float32, cuda))


# T on either side of the kernel's chunk and long; N from 1 to 32 (1 to 8
# groups of 4 states, padded); B and D at the path's width and narrow
# ones; D = 25 gives rows that are not a multiple of 16 bytes (50 in
# bf16, 100 in fp32), staged by plain loads
SCAN_CASES = (
    [(1, T, 24, 16) for T in (1, 2, CHUNK - 1, CHUNK, CHUNK + 1, 777, 1536,
                              4099)]
    + [(4, CHUNK + 1, 24, N) for N in (1, 3, 8, 16, 32)]
    + [(1, 777, 8192, 16), (4, 777, 8192, 16), (4, 777, 24, 16),
       (2, 65, 8192, 32), (2, 40, 25, 3), (1, 1, 64, 16), (2, 37, 96, 8),
       (3, 130, 40, 16), (2, 50, 24, 3)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,D,N", SCAN_CASES)
def test_mamba_scan_kernel_matches_plain_on_the_card(cuda, B, T, D, N,
                                                     dtype):
    g = torch.Generator(device=cuda).manual_seed(B * 7919 + T * 31 + N)
    args = _scan_inputs(g, B, T, D, N, dtype, cuda)
    launched = SCANS.kernel_launches
    by_dtype = dict(DTYPE_LAUNCHES)
    y, hT = mamba_scan(*args)
    assert SCANS.kernel_launches == launched + 1
    name = str(dtype).removeprefix("torch.")
    assert DTYPE_LAUNCHES == dict(by_dtype, **{name: by_dtype[name] + 1})
    assert y.dtype == dtype and hT.dtype == torch.float32
    assert hT.shape == (B, D, N)
    y_want, h_want = mamba_scan_ref(*args)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y, y_want, atol=tol, rtol=tol)
    torch.testing.assert_close(hT, h_want, atol=2e-4, rtol=2e-4)


# --------------------------------------------------------------- dot_seen
TOP = 2**31 - 1


def _dot_seen_inputs(n_actors, n_runs, n_dots, seed):
    """Unsorted rows with overlapping and duplicate runs and empty slots
    (1, 0); dots with actors -1 .. A (outside [0, A) at both ends),
    counters 0, 1 and 2^31 - 1, on the runs' edges and anywhere.  Actor
    0's row is empty but for its last run, so the dots on it can hit only
    in the last stride's last lane."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 2**31 - 2**20, (n_actors, n_runs))
    e = s + rng.integers(-2, 2**20, (n_actors, n_runs))
    if n_runs > 3:
        s[:, 3], e[:, 3] = s[:, 1], e[:, 1]                  # duplicate
        s[:, 2], e[:, 2] = s[:, 1] + 5, e[:, 1] + 2**19      # overlap
    empty = rng.random((n_actors, n_runs)) < 0.2
    s[empty], e[empty] = 1, 0
    s[1 % n_actors, 0], e[1 % n_actors, 0] = 1, TOP            # reach the top
    s[0], e[0] = 1, 0
    s[0, -1], e[0, -1] = 777, 779
    actors = rng.integers(-1, n_actors + 1, n_dots)
    pick = rng.integers(0, n_runs, n_dots)
    row = np.clip(actors, 0, n_actors - 1)
    edge = rng.integers(0, 6, n_dots)
    base = np.where(edge < 3, s[row, pick], e[row, pick])
    base = base + np.choose(edge, [-1, 0, 1, -1, 0, 1])
    counters = np.where(rng.random(n_dots) < 0.6, base,
                        rng.integers(0, TOP, n_dots, endpoint=True))
    counters[:6] = [0, 1, TOP, 777, 778, 779]
    actors[:6] = [0, 1, 1 % n_actors, 0, 0, 0]
    counters = np.clip(counters, 0, TOP)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
            for a in (s, np.minimum(e, TOP), actors, counters)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_actors", [3, 200])
@pytest.mark.parametrize("n_runs", [1, 3, 12, 31, 32, 33, 2000, 4096])
def test_dot_seen_kernel_matches_plain_bit_for_bit(cuda, n_runs, n_actors):
    # rows shorter than a warp, of one, and longer; 3 actors of up to 2,000
    # runs are staged in shared memory, wider or more rows are read from
    # global memory; 1,037 dots fill no block
    starts, ends, actors, counters = (
        t.to(cuda) for t in _dot_seen_inputs(n_actors, n_runs, 1037,
                                             n_runs + n_actors))
    geometry = dot_seen_plan(n_actors, n_runs, 1037)
    assert geometry.staged == (2 * n_actors * n_runs <= 12 * 1024)
    launched = DOTS.kernel_launches
    got = dot_seen(DenseClock(starts, ends), actors, counters)
    assert DOTS.kernel_launches == launched + 1
    want = dot_seen_ref(starts, ends, actors, counters)
    assert got.dtype == torch.bool
    assert torch.equal(got, want)
    assert got[3:6].tolist() == [True] * 3  # actor 0's last run only
    assert bool(want.any()) and not bool(want.all())


@pytest.mark.gpu
def test_scan_and_dot_seen_wrappers_replay_in_a_cuda_graph(cuda):
    # the launch geometry is fixed at capture; new inputs in the captured
    # tensors give the plain result on replay
    g = torch.Generator(device=cuda).manual_seed(4)
    scan_args = _scan_inputs(g, 1, 100, 96, 16, torch.bfloat16, cuda)
    dots = [t.to(cuda) for t in _dot_seen_inputs(2, 2000, 1024, 1)]

    def step():
        return (mamba_scan(*scan_args),
                dot_seen(DenseClock(dots[0], dots[1]), dots[2], dots[3]))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        (y, hT), seen = step()
    for seed in (5, 6):
        fresh = _scan_inputs(torch.Generator(device=cuda).manual_seed(seed),
                             1, 100, 96, 16, torch.bfloat16, cuda)
        for t, new in zip(scan_args, fresh):
            t.copy_(new)
        for t, new in zip(dots, _dot_seen_inputs(2, 2000, 1024, seed)):
            t.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        y_want, h_want = mamba_scan_ref(*scan_args)
        torch.testing.assert_close(y, y_want, atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(hT, h_want, atol=2e-4, rtol=2e-4)
        assert torch.equal(seen, dot_seen_ref(*dots))


# ------------------------------------------------------------ clock lattice
CLOCK_MODES = (("join", "or", clock_ops.join_ref),
               ("subtract", "andnot", clock_ops.subtract_ref),
               ("intersect", "and", clock_ops.intersect_ref))
LOW = -2**31


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


def _canonical_clock_rows(rng, n_actors, n_runs, hi):
    """Sorted, disjoint runs, valid ones first: the rows from_clock builds
    and every merge returns (the bigset path's case)."""
    s = np.ones((n_actors, n_runs), np.int64)
    e = np.zeros((n_actors, n_runs), np.int64)
    for a in range(n_actors):
        used = int(rng.integers(0, n_runs + 1))
        edges = np.unique(rng.integers(0, hi, 2 * used + 64))
        edges = np.sort(rng.choice(edges, 2 * used, replace=False))
        s[a, :used], e[a, :used] = edges[0::2], edges[1::2]
    return s.astype(np.int32), e.astype(np.int32)


def _chained_clock_rows(rng, n_actors, n_runs):
    """Shuffled runs that overlap their neighbours: each row coalesces into
    the one run [0, 5 * n_runs + 2]."""
    s = np.arange(n_runs) * 5
    rows = [rng.permutation(n_runs) for _ in range(n_actors)]
    return (np.stack([s[r] for r in rows]).astype(np.int32),
            np.stack([s[r] + 7 for r in rows]).astype(np.int32))


CLOCK_SHAPES = {"ragged": (13, 25, 7, 300),   # A, Ra, Rb, counters below
                "tomb": (1, 2000, 2000, 100_000),  # the bigset tombstone
                "churn": (512, 128, 128, TOP),  # 512 actors of 128 runs
                "many": (2048, 8, 8, TOP),      # many short rows
                "wide": (3, 9000, 7000, TOP),   # rows past shared memory
                "r0": (5, 0, 1, 300),           # popcount: no runs,
                "r1": (7, 1, 1, 300),           # one run,
                "r2001": (3, 2001, 2001, TOP)}  # rows not on 16 bytes


def _clock_inputs(shape, cuda):
    rng = np.random.default_rng(5)
    if shape == "edge":
        arrays = _edge_rows()
    elif shape == "canonical":
        arrays = (*_canonical_clock_rows(rng, 64, 300, 2**31),
                  *_canonical_clock_rows(rng, 64, 200, 2**31))
    elif shape == "coalesce":
        arrays = (*_chained_clock_rows(rng, 4, 40),
                  *_chained_clock_rows(rng, 4, 30))
    else:
        n_actors, ra, rb, hi = CLOCK_SHAPES[shape]
        arrays = (*_clock_rows(rng, n_actors, ra, hi),
                  *_clock_rows(rng, n_actors, rb, hi))
    return [torch.from_numpy(x).to(cuda) for x in arrays]


def _plain_merge(ref, a_s, a_e, b_s, b_e):
    """The plain version, sorted: the canonical rows.  It runs on a few
    rows at a time, so its [A, P, P] masks stay small."""
    p = a_s.shape[1] + b_s.shape[1]
    rows = max(1, (1 << 24) // (p * p))
    parts = [ref(a_s[i:i + rows], a_e[i:i + rows], b_s[i:i + rows],
                 b_e[i:i + rows]) for i in range(0, a_s.shape[0], rows)]
    return sort_runs(*(torch.cat(x) for x in zip(*parts)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["ragged", "edge", "tomb", "churn",
                                   "wide", "canonical", "coalesce", "many"])
def test_clock_merge_kernel_matches_plain_on_the_card(cuda, shape):
    a_s, a_e, b_s, b_e = _clock_inputs(shape, cuda)
    ra, rb = a_s.shape[1], b_s.shape[1]
    # rows past a block's shared memory take the global-memory route
    assert clock_staged(ra, rb, cuda) == (shape != "wide")
    a, b = DenseClock(a_s, a_e), DenseClock(b_s, b_e)
    merges = clock_ops.DISPATCHES.merge
    for op, mode, ref in CLOCK_MODES:
        want = _plain_merge(ref, a_s, a_e, b_s, b_e)
        raw = clock_ops.clock_merge_cuda(mode, a_s, a_e, b_s, b_e)
        # the kernel writes the canonical rows: the plain version's, sorted
        assert all(torch.equal(g, w) for g, w in zip(raw, want))
        launched = merges.kernel_launches
        got = getattr(clock_ops, op)(a, b)
        assert merges.kernel_launches == launched + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    if shape == "coalesce":
        assert clock_ops.join(a, b).starts[:, :2].tolist() == [[0, 1]] * 4
        assert clock_ops.join(a, b).ends[:, :2].tolist() == [[202, 0]] * 4


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["ragged", "tomb"])
def test_clock_wrappers_replay_in_a_cuda_graph(cuda, shape):
    # the route and the launch geometry are fixed at capture; new rows in
    # the captured tensors give the plain result on replay
    arrays = _clock_inputs(shape, cuda)
    a, b = DenseClock(*arrays[:2]), DenseClock(*arrays[2:])

    def step():
        return ([getattr(clock_ops, op)(a, b) for op, _, _ in CLOCK_MODES],
                clock_ops.popcount(a))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        merged, counts = step()
    n_actors, ra, rb, hi = CLOCK_SHAPES[shape]
    for seed in (6, 7):
        rng = np.random.default_rng(seed)
        fresh = (*_clock_rows(rng, n_actors, ra, hi),
                 *_clock_rows(rng, n_actors, rb, hi))
        for t, new in zip(arrays, fresh):
            t.copy_(torch.from_numpy(new))
        graph.replay()
        torch.cuda.synchronize()
        for got, (_, _, ref) in zip(merged, CLOCK_MODES):
            want = _plain_merge(ref, *arrays)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert torch.equal(counts, clock_ops.popcount_ref(*arrays[:2]))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["ragged", "edge", "tomb", "churn",
                                   "wide", "many", "r0", "r1", "r2001"])
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


# ------------------------------------------------------- attention backward
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, (1e-4, 1e-5, None)),
                                       (torch.bfloat16, (1.6e-2, 1e-3, 1e-3))])
@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,window,causal", [
    pytest.param(1, 4, 2, 128, 128, 64, None, True, id="causal-gqa"),
    pytest.param(2, 4, 4, 200, 200, 128, 64, True, id="window-mha"),
    pytest.param(1, 8, 2, 63, 63, 128, None, True, id="ragged-T"),
    pytest.param(1, 2, 2, 40, 20, 64, None, True, id="T-over-S"),
    pytest.param(1, 2, 1, 65, 130, 256, None, True, id="D256"),
    pytest.param(1, 4, 2, 77, 77, 16, 9, True, id="narrow-window"),
    pytest.param(1, 4, 2, 130, 100, 64, None, False, id="not-causal"),
    # whisper-tiny's cross-attention (448 decoder positions against 1,500
    # encoder positions) and its encoder, 6 heads of 64
    pytest.param(1, 6, 6, 448, 1500, 64, None, False,
                 id="cross-not-causal"),
    pytest.param(1, 6, 6, 1500, 1500, 64, None, False,
                 id="encoder-not-causal"),
    pytest.param(1, 4, 2, 70, 300, 128, None, True, id="T-under-S-tail"),
    pytest.param(1, 24, 8, 512, 512, 128, None, True,
                 id="train-grouping-24-8"),
    # mistral-large-123b's group of 12: a key's dK / dV sums 12 x 1,024
    # rows
    pytest.param(1, 24, 2, 1024, 1024, 128, None, True,
                 id="mistral-grouping-12"),
    # head dims below a block of columns: zeros pad them to 64 / 128
    pytest.param(1, 4, 2, 96, 96, 8, None, True, id="D8"),
    pytest.param(1, 4, 2, 130, 130, 40, 50, True, id="D40-window"),
    pytest.param(1, 6, 2, 100, 160, 80, None, True, id="D80-T-under-S"),
])
def test_flash_backward_kernel_matches_plain(cuda, dtype, tol, B, Hq, Hkv, T,
                                             S, D, window, causal):
    g = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v = (_normal(g, (B, h, n, D), dtype, cuda).requires_grad_()
               for h, n in ((Hq, T), (Hkv, S), (Hkv, S)))
    dout = _normal(g, (B, Hq, T, D), dtype, cuda)
    launched = BWD_DISPATCHES.kernel_launches
    route = flash_bwd_route(dtype)
    by_route = BWD_ROUTE_LAUNCHES[route]
    out = flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert BWD_DISPATCHES.kernel_launches == launched + 1
    assert BWD_ROUTE_LAUNCHES[route] == by_route + 1
    # bf16 takes the tensor cores at every head dim here, fp32 the SIMT
    assert route == ("tc" if dtype == torch.bfloat16 else "simt")
    lse = attention_lse_ref(q.detach(), k.detach(), causal=causal,
                            window=window)
    want = attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                             out.detach(), dout, lse, causal=causal,
                             window=window)
    rtol, atol, rel = tol
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)
        if rel is not None:
            err = (a.float() - b.float()).norm() / b.float().norm()
            assert float(err) <= rel
    again = torch.autograd.grad(
        flash_attention(q, k, v, causal=causal, window=window), (q, k, v),
        dout)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if causal and T > S:  # the first T - S rows see no key
        assert torch.all(got[0][:, :, :T - S] == 0)


def _smoke_train(cuda):
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("minitron-4b")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 33))
    return cfg, build_model, torch.as_tensor(tok, dtype=torch.int32)


@pytest.mark.gpu
def test_gradients_reach_the_attention_projections_on_the_card(cuda):
    cfg, build_model, tok = _smoke_train(cuda)
    model = build_model(cfg, cuda)
    launched = BWD_DISPATCHES.kernel_launches
    loss, grads = model.grad_step(model.init(0), {"tokens": tok.to(cuda)})
    assert torch.isfinite(loss)
    assert BWD_DISPATCHES.kernel_launches == launched + cfg.n_layers
    for layer in grads["layers"]:
        for name in ("wq", "wk", "wv"):
            assert float(layer["attn"][name].abs().sum()) > 0, name


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.tree import leaves, map_tree
    cfg, build_model, tok = _smoke_train(cuda)
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    state = cpu.init_train_state(0)
    gstate = map_tree(lambda t: t.to(cuda), state)
    state, m_cpu = cpu.train_step(state, {"tokens": tok})
    gstate, m_gpu = gpu.train_step(gstate, {"tokens": tok.to(cuda)})
    assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                 abs=1e-4)
    for a, b in zip(leaves(gstate.params), leaves(state.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
