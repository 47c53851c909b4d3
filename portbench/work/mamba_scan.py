"""B6, the selective scan: per state element and step delta*A, exp,
a*h, (delta x)*B, +, *C and the sum over states, per channel and step
delta*x, x*D and +; x, delta read and y written once in the model's type,
B, C read in it, A, D read and the final state written in fp32, and in
training the fp32 states entering each 16 steps written.  Serving calls
it once a layer per prefill; training twice a layer per step."""
LEDGER = ("repro_torch.kernels.mamba_scan.ops", "DISPATCHES")
PEAK = "fp32_flops"


def calls(spec, fed):
    if not spec.mamba_layers:
        return []
    d, n = spec.d_inner, spec.ssm_state
    if fed["kind"] == "serve":
        return [dict(B=1, T=T, D=d, N=n, edges=0)
                for T in fed["prefill_lens"] for _ in range(spec.mamba_layers)]
    B, T = fed["rows"], fed["seq"] - 1
    edges = B * (-(-T // 16)) * (-(-n // 4)) * d * 4
    return [dict(B=B, T=T, D=d, N=n, edges=edges)
            ] * (2 * spec.mamba_layers * fed["steps"])


def work(c):
    B, T, D, N = c["B"], c["T"], c["D"], c["N"]
    flops = B * T * D * (7 * N + 3)
    nbytes = 2 * (3 * B * T * D + 2 * B * T * N) \
        + 4 * (D * N + D + B * D * N) + 4 * c["edges"]
    return flops, nbytes
