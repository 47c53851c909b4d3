"""The selective scan backward's host-side plan and its decomposition, on
the CPU.

``kernel.bwd_plan`` cuts T into segments of whole 16-step windows (at
least two where T allows, more until the grid has ``MIN_BLOCKS`` blocks)
and the steps after the first segment into carry pieces; the wrapper
allocates its scratch from the plan and the train variant's edges from
``kernel.edges_shape``.  Those are pure arithmetic and are checked here for
T = 1, 31, 32, 33, 4,096 and 4,097 at ``falcon-mamba-7b``'s training width
and for every N the kernels take.  The decomposition the CUDA launches
compute (each piece's ``(L, P)``, the fold ``G = L + P G`` from the last
piece to the first, each segment's reverse walk from ``G`` over windows
recomputed from their edges) is written out in float64 and held against
float64 autograd of the plain recurrence within 1e-9 of each gradient's
largest entry: it is the same gradient, summed in another order.  The
kernels themselves run only on a card
(``tests/test_torch_cuda_mamba_bwd.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.mamba_scan import kernel as mk

FALCON = dict(B=1, D=8192, N=16)  # the SSM training path's batch row
# T: (seg_len, n_seg, piece_len, n_pieces)
PLANS = {1: (16, 1, 16, 0), 31: (16, 2, 16, 1), 32: (16, 2, 16, 1),
         33: (32, 2, 32, 1), 4096: (2048, 2, 128, 16),
         4097: (2176, 2, 128, 16)}


@pytest.mark.parametrize("T", sorted(PLANS))
def test_plan_segments_pieces_and_scratch(T):
    B, D, N = FALCON["B"], FALCON["D"], FALCON["N"]
    plan = mk.bwd_plan(B, T, D, N)
    assert (plan.seg_len, plan.n_seg, plan.piece_len, plan.n_pieces) \
        == PLANS[T]
    assert (plan.groups, plan.channels, plan.threads, plan.n_blk) \
        == (4, 64, 256, 128)
    # segments: whole windows, covering T, none empty
    assert plan.seg_len % mk.EDGE == 0 and plan.seg_len % plan.piece_len == 0
    assert (plan.n_seg - 1) * plan.seg_len < T <= plan.n_seg * plan.seg_len
    # pieces: the steps after the first segment, none empty, at most PIECE
    assert plan.piece_len <= mk.PIECE and plan.piece_len % mk.EDGE == 0
    after = max(0, T - plan.seg_len) if plan.n_seg > 1 else 0
    assert (plan.n_pieces - 1) * plan.piece_len < after \
        <= plan.n_pieces * plan.piece_len or plan.n_pieces == after == 0
    assert plan.scratch_shapes(B, T, D, N) == {
        "dbc_part": (2, 128, B, T, N), "dA_part": (B, plan.n_seg, D, N),
        "dD_part": (B, plan.n_seg, D),
        "carry": (2, B, plan.n_pieces, D, N)}
    assert mk.edges_shape(B, T, D, N) == (B, -(-T // 16), 4, D, 4)
    assert plan.exps_per_state_step(T) == pytest.approx(1.5 + after / T)


@pytest.mark.parametrize("N", [1, 3, 4, 5, 8, 9, 16, 17, 32])
def test_plan_threads_a_channel(N):
    plan = mk.bwd_plan(2, 300, 1000, N)
    assert plan.groups & (plan.groups - 1) == 0
    assert 4 * plan.groups >= N > 2 * plan.groups or plan.groups == 1
    assert plan.threads == 64 * plan.groups <= 512
    assert plan.n_blk == 16


def test_plan_fills_the_grid_before_it_shortens_segments():
    # few channel blocks: segments shrink until the grid has MIN_BLOCKS
    # blocks or a segment is one window
    plan = mk.bwd_plan(1, 4096, 64, 16)
    assert plan.n_blk * plan.n_seg >= mk.MIN_BLOCKS
    assert mk.bwd_plan(1, 100, 64, 16).seg_len == mk.EDGE
    # a full grid: two segments
    assert mk.bwd_plan(1, 4096, 16384, 16).n_seg == 2


def test_edge_states_reads_the_layout():
    B, E, D, N = 2, 3, 5, 6
    K4 = -(-N // 4)
    edges = torch.arange(B * E * K4 * D * 4, dtype=torch.float32).reshape(
        B, E, K4, D, 4)
    got = mk.edge_states(edges, N)
    assert got.shape == (B, E, D, N)
    for n in range(N):
        assert torch.equal(got[..., n], edges[:, :, n // 4, :, n % 4])


def _scan64(x, delta, A, Bm, Cm, Dp):
    """y of the plain recurrence, in the inputs' type."""
    h, ys = torch.zeros((x.shape[0], x.shape[2], A.shape[1]),
                        dtype=x.dtype), []
    for t in range(x.shape[1]):
        h = torch.exp(delta[:, t, :, None] * A) * h \
            + (delta[:, t] * x[:, t])[:, :, None] * Bm[:, t, None, :]
        ys.append((h * Cm[:, t, None, :]).sum(-1) + Dp * x[:, t])
    return torch.stack(ys, 1)


def _segmented_bwd(x, delta, A, Bm, Cm, Dp, dy):
    """The launches' decomposition in float64 on the plan: the train
    variant's edges, the carry's pieces, the fold, each segment's walk."""
    Bsz, T, D = x.shape
    N = A.shape[1]
    plan = mk.bwd_plan(Bsz, T, D, N)

    def a_of(t):
        return torch.exp(delta[:, t, :, None] * A)

    def bx_of(t):
        return (delta[:, t] * x[:, t])[:, :, None] * Bm[:, t, None, :]

    edges, h = [], torch.zeros((Bsz, D, N), dtype=x.dtype)
    for t in range(T):
        if t % mk.EDGE == 0:
            edges.append(h)
        h = a_of(t) * h + bx_of(t)
    pieces = []
    for p in range(plan.n_pieces):
        f = plan.seg_len + p * plan.piece_len
        e = min(T, f + plan.piece_len) - 1
        g, an, P = 0.0, 1.0, 1.0
        for t in range(e, f - 1, -1):
            a = a_of(t)
            g = an * g + dy[:, t, :, None] * Cm[:, t, None, :]
            P, an = P * a, a
        pieces.append((an * g, P))
    dx, dd = torch.zeros_like(x), torch.zeros_like(x)
    dB, dC = torch.zeros_like(Bm), torch.zeros_like(Cm)
    dA = torch.zeros_like(A)
    for s in range(plan.n_seg):
        g = torch.zeros((Bsz, D, N), dtype=x.dtype)
        if s + 1 < plan.n_seg:
            for p in range(plan.n_pieces - 1,
                           s * plan.seg_len // plan.piece_len - 1, -1):
                g = pieces[p][0] + pieces[p][1] * g
        an = 1.0
        lo, hi = s * plan.seg_len, min(T, (s + 1) * plan.seg_len)
        for w in range((hi - lo - 1) // mk.EDGE, -1, -1):
            t0 = lo + w * mk.EDGE
            hs = [edges[t0 // mk.EDGE]]
            for t in range(t0, min(hi, t0 + mk.EDGE)):
                hs.append(a_of(t) * hs[-1] + bx_of(t))
            for t in range(min(hi, t0 + mk.EDGE) - 1, t0 - 1, -1):
                a = a_of(t)
                g = an * g + dy[:, t, :, None] * Cm[:, t, None, :]
                gah = g * a * hs[t - t0]
                dx[:, t] = delta[:, t] * (g * Bm[:, t, None, :]).sum(-1) \
                    + Dp * dy[:, t]
                dd[:, t] = x[:, t] * (g * Bm[:, t, None, :]).sum(-1) \
                    + (gah * A).sum(-1)
                dB[:, t] = (g * (delta[:, t] * x[:, t])[:, :, None]).sum(1)
                dC[:, t] = (dy[:, t, :, None] * hs[t - t0 + 1]).sum(1)
                dA += (gah * delta[:, t, :, None]).sum(0)
                an = a
    return dx, dd, dA, dB, dC, (dy * x).sum((0, 1))


@pytest.mark.parametrize("B,T,D,N", [(1, 1, 8, 1), (1, 17, 64, 16),
                                     (3, 100, 100, 3), (2, 70, 40, 32),
                                     (3, 300, 64, 8), (1, 4097, 8, 4)])
def test_segmented_decomposition_is_the_plain_gradient(B, T, D, N):
    rng = np.random.default_rng(T + N)

    def f64(*shape):
        return torch.from_numpy(rng.standard_normal(shape))

    x, dy, Bm, Cm, Dp = f64(B, T, D), f64(B, T, D), f64(B, T, N), \
        f64(B, T, N), f64(D)
    delta = torch.nn.functional.softplus(f64(B, T, D) - 4.6)
    A = -torch.arange(1, N + 1, dtype=torch.float64).repeat(D, 1) \
        * torch.exp(0.1 * f64(D, N))
    plan = mk.bwd_plan(B, T, D, N)
    if T > mk.EDGE:
        assert plan.n_seg > 1
    got = _segmented_bwd(x, delta, A, Bm, Cm, Dp, dy)
    leaves = [t.clone().requires_grad_() for t in (x, delta, A, Bm, Cm, Dp)]
    want = torch.autograd.grad(_scan64(*leaves), leaves, dy)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) \
            <= 1e-9 * max(1.0, float(w.abs().max()))
