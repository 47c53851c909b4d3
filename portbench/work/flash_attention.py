"""B4, the prefill and training forward of attention: per call the two
products of the visible pairs (4 x head dim operations a pair and query
head), q, k, v read and the output written once, and in training the
rows' log-sum-exps written too.  Serving calls it once a layer per
prefill; training twice a layer per step (the layer is recomputed in the
backward)."""
from . import causal_pairs

LEDGER = ("repro_torch.kernels.flash_attention.ops", "DISPATCHES")
PEAK = "bf16_dense_flops"


def calls(spec, fed):
    hq, hk, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
    if not spec.attn_layers:
        return []
    if fed["kind"] == "serve":
        return [dict(B=1, Hq=hq, Hkv=hk, T=T, D=d, lse=False)
                for T in fed["prefill_lens"] for _ in range(spec.attn_layers)]
    return [dict(B=fed["rows"], Hq=hq, Hkv=hk, T=fed["seq"] - 1, D=d, lse=True)
            ] * (2 * spec.attn_layers * fed["steps"])


def work(c):
    B, Hq, Hkv, T, D = c["B"], c["Hq"], c["Hkv"], c["T"], c["D"]
    flops = 4 * D * causal_pairs(T) * Hq * B
    nbytes = 2 * (2 * B * Hq * T * D + 2 * B * Hkv * T * D)
    if c["lse"]:
        nbytes += 4 * B * Hq * T
    return flops, nbytes
