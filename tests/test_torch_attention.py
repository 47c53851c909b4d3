"""The port's attention kernels' plain versions (and their wrappers, on the
CPU) against the JAX package's references and its Pallas kernels in
interpret mode, at the cases of ``tests/test_kernels.py`` plus ragged T.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py`` hold them against the same plain
versions there.  Tolerances are those of the JAX package's
kernel tests: 2e-5 in fp32; 2e-2 (prefill) and 3e-2 (decode) in bf16,
where the two sides round scores and probabilities at other places.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from numpy.testing import assert_allclose

from repro.kernels.decode_attention import (decode_attention_pallas,
                                            decode_attention_ref as jax_decode_ref)
from repro.kernels.flash_attention import (attention_ref as jax_attention_ref,
                                           flash_attention_pallas)
from repro_torch.configs import ARCHS
from repro_torch.kernels import decode_attention as dec_pkg
from repro_torch.kernels import flash_attention as fa_pkg
from repro_torch.kernels.decode_attention.kernel import (MIN_BLOCKS,
                                                         plan_splits,
                                                         scratch_shapes)
from repro_torch.kernels.flash_attention.kernel import (flash_bwd_route,
                                                        flash_route)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention

TORCH_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _pair(rng, shape, dtype):
    """The same seeded normals as a JAX array and a torch tensor."""
    a = jnp.asarray(rng.standard_normal(shape), dtype)
    t = torch.tensor(np.asarray(a, np.float32)).to(TORCH_DT[dtype])
    return a, t


def _close(got, want, dtype, bf16_tol):
    tol = bf16_tol if dtype == jnp.bfloat16 else 2e-5
    assert_allclose(np.asarray(got.float() if isinstance(got, torch.Tensor)
                               else got, np.float32),
                    np.asarray(want, np.float32), atol=tol, rtol=tol)


# ------------------------------------------------------------ flash attention
FLASH_CASES = [
    # B, Hq, Hkv, T, S, D, dtype, causal, window
    (1, 2, 2, 128, 128, 64, jnp.float32, True, None),
    (2, 4, 2, 256, 256, 64, jnp.float32, True, None),    # GQA group 2
    (1, 8, 1, 128, 128, 128, jnp.float32, True, None),   # MQA-ish
    (1, 2, 2, 256, 256, 128, jnp.bfloat16, True, None),
    (1, 2, 2, 256, 256, 64, jnp.float32, True, 64),      # sliding window
    (1, 2, 2, 256, 256, 64, jnp.float32, True, 128),
    (1, 2, 2, 256, 256, 64, jnp.float32, True, 999),
    (1, 1, 1, 128, 128, 64, jnp.float32, False, None),   # noncausal
    # mistral-large-123b's group of 12 (96 over 8 heads) and
    # pixtral-12b's of 4 (32 over 8)
    (1, 24, 2, 128, 128, 64, jnp.float32, True, None),
    (1, 12, 1, 128, 128, 128, jnp.bfloat16, True, None),
    (1, 8, 2, 256, 256, 128, jnp.float32, True, None),
]


@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,dtype,causal,window", FLASH_CASES)
def test_flash_plain_matches_jax_ref_and_pallas(B, Hq, Hkv, T, S, D, dtype,
                                                causal, window):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng, (B, Hq, T, D), dtype)
    jk, tk = _pair(rng, (B, Hkv, S, D), dtype)
    jv, tv = _pair(rng, (B, Hkv, S, D), dtype)
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, Hq, T, D)
    want = jax_attention_ref(jq, jk, jv, causal=causal, window=window)
    _close(got, want, dtype, 2e-2)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                    block_q=64, block_kv=64)
    _close(got, pallas, dtype, 2e-2)


@pytest.mark.parametrize("T,S,window", [
    (37, 200, None),     # ragged T at the tail of a longer context
    (37, 200, 50),
    (1, 130, 16),        # one query row
    (130, 130, 24),      # ragged T == S, window
    (1100, 1100, 300),   # past the plain version's 1024-row query chunk
])
def test_flash_plain_ragged_T(T, S, window):
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng, (1, 4, T, 16), jnp.float32)
    jk, tk = _pair(rng, (1, 2, S, 16), jnp.float32)
    jv, tv = _pair(rng, (1, 2, S, 16), jnp.float32)
    got = flash_attention(tq, tk, tv, causal=True, window=window)
    want = jax_attention_ref(jq, jk, jv, causal=True, window=window)
    _close(got, want, jnp.float32, None)


def test_flash_fully_masked_rows_give_zero():
    # more queries than keys: the first T - S rows see no key at all
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 2, 10, 16))).float()
    k = torch.from_numpy(rng.standard_normal((1, 2, 4, 16))).float()
    out = attention_ref(q, k, k.clone(), causal=True)
    assert torch.all(out[:, :, :6] == 0)
    assert torch.all(out[:, :, 6:].abs().sum(-1) > 0)


# ------------------------------------------------------------ decode attention
DECODE_CASES = [
    # B, Hq, Hkv, S, D, dtype, window
    (2, 4, 4, 256, 64, jnp.float32, None),
    (1, 8, 2, 512, 64, jnp.float32, None),     # GQA group 4
    (2, 4, 1, 256, 128, jnp.bfloat16, None),
    (1, 4, 2, 512, 64, jnp.float32, 128),      # windowed decode
    # mistral-large-123b's group of 12, which the CUDA kernel cuts into
    # two chunks of 6 heads a block
    (2, 24, 2, 256, 64, jnp.float32, None),
    (2, 12, 1, 512, 128, jnp.bfloat16, None),
]


@pytest.mark.parametrize("B,Hq,Hkv,S,D,dtype,window", DECODE_CASES)
def test_decode_plain_matches_jax_ref_and_pallas(B, Hq, Hkv, S, D, dtype,
                                                 window):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (B, Hq, D), dtype)
    jk, tk = _pair(rng, (B, Hkv, S, D), dtype)
    jv, tv = _pair(rng, (B, Hkv, S, D), dtype)
    lens = rng.integers(1, S + 1, B).astype(np.int32)
    if window is not None:
        lens[:] = 400
    tl = torch.from_numpy(lens)
    got = decode_attention(tq, tk, tv, tl, window=window)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, Hq, D)
    want = jax_decode_ref(jq, jk, jv, jnp.asarray(lens), window=window)
    _close(got, want, dtype, 3e-2)
    pallas = decode_attention_pallas(jq, jk, jv, jnp.asarray(lens),
                                     window=window, block_kv=128)
    _close(got, pallas, dtype, 3e-2)


def test_decode_plain_ragged_cache_len():
    # one row per length class: a single slot, a partial tile, a full cache
    rng = np.random.default_rng(4)
    jq, tq = _pair(rng, (4, 6, 16), jnp.float32)
    jk, tk = _pair(rng, (4, 3, 100, 16), jnp.float32)
    jv, tv = _pair(rng, (4, 3, 100, 16), jnp.float32)
    lens = np.array([1, 37, 99, 100], np.int32)
    got = decode_attention(tq, tk, tv, torch.from_numpy(lens))
    want = jax_decode_ref(jq, jk, jv, jnp.asarray(lens))
    _close(got, want, jnp.float32, None)
    # each row sees exactly its prefix: changing a slot past it changes nothing
    tk2 = tk.clone()
    tk2[0, :, 1:] = 1e3
    again = decode_attention_ref(tq, tk2, tv, torch.from_numpy(lens))
    assert torch.equal(again[0], got[0])


# ------------------------------------------------------------------ wrappers
def test_wrappers_count_cpu_calls_but_no_kernel_launch():
    q = torch.zeros((1, 2, 8, 16))
    k = torch.zeros((1, 1, 8, 16))
    fa_pkg.DISPATCHES.reset()
    dec_pkg.DISPATCHES.reset()
    flash_attention(q, k, k)
    decode_attention(q[:, :, 0].contiguous(), k, k,
                     torch.tensor([3], dtype=torch.int32))
    assert vars(fa_pkg.DISPATCHES) == dict(launches=1, rows=16,
                                           kernel_launches=0)
    assert vars(dec_pkg.DISPATCHES) == dict(launches=1, rows=2,
                                            kernel_launches=0)


@pytest.mark.parametrize("bad", ["dtype", "mixed", "gqa", "contig", "window",
                                 "rank", "lens"])
def test_wrappers_check_their_arguments(bad):
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    v = torch.zeros((1, 2, 8, 16))
    lens = torch.tensor([3], dtype=torch.int32)
    kw = {}
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        k = k.double()
    elif bad == "gqa":
        q = torch.zeros((1, 3, 8, 16))
    elif bad == "contig":
        q = torch.zeros((1, 4, 16, 8)).transpose(2, 3)
    elif bad == "window":
        kw["window"] = 0
    elif bad == "rank":
        q = q[0]
    elif bad == "lens":
        lens = lens.long()
    with pytest.raises((TypeError, ValueError)):
        if bad == "lens":
            decode_attention(q[:, :, 0].contiguous(), k, v, lens)
        else:
            flash_attention(q, k, v, **kw)


def test_kernel_modules_build_nothing_on_import():
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    # planning a launch is host arithmetic: it builds nothing either
    flash_route(torch.bfloat16, 128)
    flash_bwd_route(torch.bfloat16)
    dk.scratch_shapes(4, 32, 16, 2048, 128)
    assert fk.library.cache_info().currsize == 0
    assert fk.bwd_library.cache_info().currsize == 0
    assert dk.library.cache_info().currsize == 0
    assert fk.SOURCE.is_file() and dk.SOURCE.is_file()


# ------------------------------------------------------------------ routes
ATTN_HEAD_DIMS = sorted({c.head_dim for c in ARCHS.values() if c.head_dim})


@pytest.mark.parametrize("dtype,D,route", [
    *((torch.bfloat16, D, "tc") for D in ATTN_HEAD_DIMS),
    *((torch.float32, D, "simt") for D in ATTN_HEAD_DIMS),
    (torch.bfloat16, 80, "tc"),      # padded in shared memory up to 128
    (torch.bfloat16, 16, "tc"),      # the smoke models' head dim
    (torch.float32, 16, "simt"),
    (torch.bfloat16, 8, "simt"),     # not a multiple of wgmma's k16
    (torch.bfloat16, 40, "simt"),
])
def test_flash_route_by_dtype_and_head_dim(dtype, D, route):
    # every configuration's head dim takes the tensor cores in bf16, and the
    # exact SIMT kernel in fp32 (on the tensor cores fp32 would be TF32)
    assert ATTN_HEAD_DIMS == [64, 128, 256]
    assert flash_route(dtype, D) == route


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tc"),
                                         (torch.float32, "simt")])
@pytest.mark.parametrize("D", sorted({*ATTN_HEAD_DIMS, 8, 16, 40, 80, 248}))
def test_flash_bwd_route_by_dtype_and_head_dim(dtype, D, route):
    # the backward's route depends on the dtype alone: bf16 takes the tensor
    # cores at every head dim the inputs' check admits (8..256 in steps of
    # 8, padded with zeros to 64, 128 or 256 columns), fp32 the exact SIMT
    # kernels; so wherever the forward takes the tensor cores, the backward
    # does too (the training path, minitron-4b, is bf16 at head dim 128)
    assert ATTN_HEAD_DIMS == [64, 128, 256]
    assert flash_bwd_route(dtype) == route
    if flash_route(dtype, D) == "tc":
        assert route == "tc"


@pytest.mark.parametrize("S,Hkv,B", [
    (2048, 16, 4),   # the serve path's global layers: 8 splits of 256
    (1024, 16, 4),   # its local layers' ring buffer
    (4096, 8, 3), (2048, 1, 1), (100, 2, 1), (64, 1, 1), (1, 1, 1),
    (65, 8, 1), (8192, 64, 16),
])
def test_decode_split_plan_tiles_the_cache(S, Hkv, B):
    L, n = plan_splits(S, Hkv, B)
    # splits of L slots, L a multiple of 64, tile [0, S) exactly once
    assert L % 64 == 0 and n == -(-S // L)
    bounds = [(i * L, min(S, (i + 1) * L)) for i in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # enough blocks to fill the card twice where S allows, and no more
    # splits than that needs
    if L > 64:
        assert n * Hkv * B >= MIN_BLOCKS
        assert -(-S // (2 * L)) * Hkv * B < MIN_BLOCKS or 2 * L >= S
    else:
        assert n * Hkv * B >= MIN_BLOCKS or -(-S // 128) * Hkv * B < MIN_BLOCKS
    if (S, Hkv, B) == (2048, 16, 4):
        assert (L, n, n * Hkv * B) == (256, 8, 512)
    Hq, D = 2 * Hkv, 128
    assert scratch_shapes(B, Hq, Hkv, S, D) == {"ml": (B, Hq, n, 2),
                                                "acc": (B, Hq, n, D)}


# ---------------------------------------------- attention_forward, the block
# The port's attention block against the JAX package's, with the JAX
# weights carried across: non-causal self-attention (whisper's encoder),
# and cross-attention (``kv_override``: K and V from the encoder's output,
# no rope, no mask) at T < S and T = 1, in train and in decode mode, where
# the cross step still runs the prefill kernel.  The "bf16-fp32-enc" case
# is a bf16 block reading an fp32 encoder output: JAX promotes its K and V
# products to fp32 and the jnp reference casts them back to q's bf16; the
# port mirrors both steps.
BLOCK_CASES = [
    # id, dtype, T, S (encoder positions, or None: self-attention), mode
    ("noncausal-self", "float32", 24, None, "encode"),
    ("cross-T-under-S", "float32", 12, 40, "train"),
    ("cross-T1", "float32", 1, 40, "train"),
    ("cross-T1-decode-mode", "float32", 1, 40, "decode"),
    ("cross-bf16", "bfloat16", 12, 40, "train"),
    ("bf16-fp32-enc", "bfloat16", 1, 40, "train"),
]


@pytest.mark.parametrize("dtype,T,S,mode", [c[1:] for c in BLOCK_CASES],
                         ids=[c[0] for c in BLOCK_CASES])
def test_attention_block_noncausal_and_cross_match_jax(dtype, T, S, mode):
    import jax
    from repro.configs import smoke_config as jax_smoke_config
    from repro.models.attention import attention_forward as jax_block
    from repro.models.attention import init_attention as jax_init
    from repro_torch.configs import smoke_config
    from repro_torch.interop import tensor_from_numpy
    from repro_torch.models.attention import attention_forward

    jcfg = jax_smoke_config("whisper-tiny").replace(dtype=dtype)
    tcfg = smoke_config("whisper-tiny").replace(dtype=dtype)
    jdt = getattr(jnp, dtype)
    jp = jax_init(jax.random.key(3), jcfg, jdt, cross=S is not None)
    tp = {n: tensor_from_numpy(np.asarray(w), torch.device("cpu"))
          for n, w in jp.items()}
    rng = np.random.default_rng(T + (S or 0))
    B, d = 2, jcfg.d_model
    jx, tx = _pair(rng, (B, T, d), jdt)
    pos = np.broadcast_to(np.arange(T)[None], (B, T)).astype(np.int32)
    kw = dict(mode=mode)
    jkw, tkw = dict(kw), dict(kw)
    if S is None:
        jkw["causal"] = tkw["causal"] = False
    else:
        enc_dt = jnp.float32 if dtype == "bfloat16" and T == 1 else jdt
        je, te = _pair(rng, (B, S, d), enc_dt)
        jkw["kv_override"] = (je, je)
        tkw["kv_override"] = (te, te)
    want, jcache = jax_block(jp, jcfg, jx, positions=jnp.asarray(pos), **jkw)
    got, tcache = attention_forward(tp, tcfg, tx,
                                    positions=torch.from_numpy(pos), **tkw)
    assert jcache is None and tcache is None
    assert got.shape == want.shape == (B, T, d)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    _close(got, want, jdt, 2e-2)
    if S is None:
        # not causal: the first query sees the last key
        causal, _ = jax_block(jp, jcfg, jx, positions=jnp.asarray(pos),
                              mode=mode)
        assert np.abs(np.asarray(causal) - np.asarray(want))[:, 0].max() > 1e-3
