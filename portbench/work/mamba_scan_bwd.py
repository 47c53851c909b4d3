"""B6', the scan's backward, an FMA counted as two: per state element and
step 20 operations (delta*A, exp, the state's recompute, the gradient
reaching the state and its carry, the B and C terms, the sums into dx,
ddelta and dA), per channel and step 8; x, delta, dy read and dx, ddelta
written, B, C read and dB, dC written in the model's type, A, D read and
dA, dD written in fp32, and the forward's fp32 window states read.
Training calls it once a layer per step."""
LEDGER = ("repro_torch.kernels.mamba_scan.ops", "BWD_DISPATCHES")
PEAK = "fp32_flops"


def calls(spec, fed):
    if not spec.mamba_layers or fed["kind"] != "train":
        return []
    B, T, d, n = fed["rows"], fed["seq"] - 1, spec.d_inner, spec.ssm_state
    edges = B * (-(-T // 16)) * (-(-n // 4)) * d * 4
    return [dict(B=B, T=T, D=d, N=n, edges=edges)
            ] * (spec.mamba_layers * fed["steps"])


def work(c):
    B, T, D, N = c["B"], c["T"], c["D"], c["N"]
    flops = B * T * D * (20 * N + 8)
    nbytes = 2 * (5 * B * T * D + 4 * B * T * N) \
        + 4 * (2 * D * N + 2 * D) + 4 * c["edges"]
    return flops, nbytes
