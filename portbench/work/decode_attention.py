"""B5, attention of one new token a row against the cache: per call
every row's visible keys (4 x head dim operations a key and query head),
the cache's visible keys and values and the queries read and the output
written once.  Serving calls it once a layer per decode step, over every
slot of the engine."""
LEDGER = ("repro_torch.kernels.decode_attention.ops", "DISPATCHES")
PEAK = "bf16_dense_flops"


def calls(spec, fed):
    if not spec.attn_layers or fed["kind"] != "serve":
        return []
    return [dict(keys=ctx, rows=fed["decode_rows"], Hq=spec.n_heads,
                 Hkv=spec.n_kv_heads, D=spec.head_dim)
            for ctx in fed["decode_ctx"] for _ in range(spec.attn_layers)]


def work(c):
    flops = 4 * c["D"] * c["keys"] * c["Hq"]
    nbytes = 2 * (2 * c["keys"] * c["Hkv"] * c["D"]
                  + 2 * c["rows"] * c["Hq"] * c["D"])
    return flops, nbytes
