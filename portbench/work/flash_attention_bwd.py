"""B4', attention's backward: per call the five products of the visible
pairs (10 x head dim operations a pair and query head); q, k, v, the
output, its gradient and the log-sum-exps read, dq, dk, dv written once.
Training calls it once a layer per step."""
from . import causal_pairs

LEDGER = ("repro_torch.kernels.flash_attention.ops", "BWD_DISPATCHES")
PEAK = "bf16_dense_flops"


def calls(spec, fed):
    if not spec.attn_layers or fed["kind"] != "train":
        return []
    return [dict(B=fed["rows"], Hq=spec.n_heads, Hkv=spec.n_kv_heads,
                 T=fed["seq"] - 1, D=spec.head_dim)
            ] * (spec.attn_layers * fed["steps"])


def work(c):
    B, Hq, Hkv, T, D = c["B"], c["Hq"], c["Hkv"], c["T"], c["D"]
    flops = 10 * D * causal_pairs(T) * Hq * B
    nbytes = 2 * (4 * B * Hq * T * D + 4 * B * Hkv * T * D) + 4 * B * Hq * T
    return flops, nbytes
