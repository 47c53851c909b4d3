"""The work counts against hand counts at small shapes."""
import itertools

from portbench.spec import ModelSpec
from portbench.work import causal_pairs, module

DEC = ModelSpec("d", "decoder", 3, 64, 256, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128)
SSM = ModelSpec("m", "mamba1", 2, 64, 256, ssm_state=4, d_inner=128,
                dt_rank=4)


def test_causal_pairs_by_enumeration():
    for T in (1, 2, 5, 17):
        n = sum(1 for q, k in itertools.product(range(T), repeat=2) if k <= q)
        assert causal_pairs(T) == n


def test_flash_attention_by_hand():
    fa = module("flash_attention")
    c = dict(B=1, Hq=2, Hkv=1, T=4, D=8, lse=False)
    # 10 pairs x 2 heads x (QK and PV: 2 x 8 multiply-adds) ; q,o 2x4x8,
    # k,v 1x4x8, two bytes each
    assert fa.work(c) == (10 * 2 * 4 * 8, 2 * (2 * 64 + 2 * 32))
    assert fa.work(dict(c, lse=True))[1] == 2 * (2 * 64 + 2 * 32) + 4 * 2 * 4
    bwd = module("flash_attention_bwd")
    assert bwd.work(dict(B=1, Hq=2, Hkv=1, T=4, D=8)) == \
        (10 * 2 * 10 * 8, 2 * (4 * 64 + 4 * 32) + 4 * 8)


def test_calls_follow_the_fed_work():
    fa = module("flash_attention")
    serve = {"kind": "serve", "prefill_lens": [5, 7], "decode_ctx": [12, 14],
             "decode_tokens": 2, "decode_rows": 3}
    assert [c["T"] for c in fa.calls(DEC, serve)] == [5] * 3 + [7] * 3
    assert len(module("decode_attention").calls(DEC, serve)) == 2 * 3
    train = {"kind": "train", "steps": 4, "rows": 2, "seq": 33}
    assert len(fa.calls(DEC, train)) == 2 * 3 * 4      # remat: twice a layer
    assert len(module("flash_attention_bwd").calls(DEC, train)) == 3 * 4
    assert fa.calls(SSM, serve) == []
    assert len(module("mamba_scan").calls(SSM, serve)) == 2 * 2
    assert len(module("mamba_scan").calls(SSM, train)) == 2 * 2 * 4
    assert len(module("mamba_scan_bwd").calls(SSM, train)) == 2 * 4
    assert module("mamba_scan_bwd").calls(SSM, serve) == []


def test_scan_work_by_hand():
    sc = module("mamba_scan")
    c = dict(B=1, T=3, D=2, N=4, edges=0)
    flops, nbytes = sc.work(c)
    assert flops == 3 * 2 * (7 * 4 + 3)
    # x, delta, y: 3 x [1, 3, 2]; B, C: 2 x [1, 3, 4] (bf16); A [2, 4],
    # D [2], h_T [1, 2, 4] (fp32)
    assert nbytes == 2 * (3 * 6 + 2 * 12) + 4 * (8 + 2 + 8)
    train = {"kind": "train", "steps": 1, "rows": 2, "seq": 33}
    edges = module("mamba_scan").calls(SSM, train)[0]["edges"]
    assert edges == 2 * 2 * 1 * 128 * 4               # ceil(32/16), ceil(4/4)
    bflops, _ = module("mamba_scan_bwd").work(dict(c, edges=0))
    assert bflops == 3 * 2 * (20 * 4 + 8)


def test_layer_params_by_hand():
    d, f = 64, 128
    assert DEC.layer_params() == d * 16 * (4 + 2 * 2) + 4 * 16 * d + 3 * d * f
    di, n, r = 128, 4, 4
    assert SSM.layer_params() == d * 2 * di + di * (r + 2 * n) + r * di + di * d
