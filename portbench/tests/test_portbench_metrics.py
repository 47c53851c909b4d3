"""The metric arithmetic on synthetic timelines and windows."""
import statistics

import pytest

from portbench import spec as specs
from portbench.metrics import reader, serve_flops, train_flops
from portbench.spec import ModelSpec
from portbench.window import reduce_trace

DEC = ModelSpec("d", "decoder", 2, 64, 256, n_heads=4, n_kv_heads=2,
                head_dim=16, d_ff=128)


def test_classes_follow_the_data_files():
    cls = specs.kernel_classes()
    assert specs.classify("void mamba_scan_bwd_kernel<float, 4>", cls) \
        == "mamba_scan_bwd"
    assert specs.classify("mamba_scan_kernel<bf16>", cls) == "mamba_scan"
    assert specs.classify("flash_attention_kernel_tc<128>", cls) \
        == "flash_attention"
    assert specs.classify("attn_bwd_dkdv_tc", cls) == "flash_attention_bwd"
    assert specs.classify("sm90_xmma_gemm_bf16bf16", cls) == "matmul"
    assert specs.classify("nvjet_tst_128x256", cls) == "matmul"
    assert specs.classify("vectorized_elementwise_kernel", cls) == "other"


def test_busy_idle_and_where_the_host_was():
    ns = 1_000_000_000
    dev = [("gemm_a", 0, 2 * ns), ("gemm_b", 1 * ns, 3 * ns),
           ("mamba_scan_kernel", 5 * ns, 6 * ns), ("x", 9 * ns, 10 * ns)]
    spans = [("engine.step", 0, 10 * ns), ("model.decode_step", 4 * ns, 7 * ns)]
    r = reduce_trace(dev, spans)
    assert r["busy_s"] == pytest.approx(5.0)            # [0,3] + [5,6] + [9,10]
    assert r["by_class"]["matmul"] == pytest.approx(4.0)
    assert r["by_class"]["mamba_scan"] == pytest.approx(1.0)
    idle = dict(r["idle_gaps"])
    # the gap 3..5 began inside engine.step only; 6..9 inside decode_step
    assert idle["engine.step"] == pytest.approx(2.0)
    assert idle["model.decode_step"] == pytest.approx(3.0)
    assert r["device_ops"][0][0] in ("gemm_a", "gemm_b")


def _run(out, fed, trace=None):
    run = {"spec": DEC, "fed": fed, "out": out, "peaks": specs.peaks()}
    if trace:
        run["trace"] = trace
    return run


def test_rates_tail_and_idle():
    ttft = [float(i) for i in range(1, 101)]
    out = {"tokens": 5000, "window_s": 2.0, "ttft_ms": ttft, "setup_s": 7.5,
           "decode_ms": [10.0, 20.0]}
    fed = {"kind": "serve", "prefill_lens": [10], "decode_ctx": [11],
           "decode_tokens": 1, "decode_rows": 1}
    run = _run(out, fed, {"busy_s": 1.5, "by_class": {}})
    assert reader("serve_tok_per_s").read(run) == 2500.0
    p90 = reader("ttft_p90_ms").read(run)
    # ten samples lie beyond it, among 100
    assert sum(x > p90 for x in ttft) == 10
    assert p90 == statistics.quantiles(ttft, n=10, method="inclusive")[8]
    assert reader("ttft_p90_ms").read(_run(dict(out, ttft_ms=ttft[:9]), fed)) \
        is None
    assert reader("setup_s").read(run) == 7.5
    assert reader("decode_step_ms.serve").read(run) == 15.0
    assert reader("device_idle.serve").read(run) == pytest.approx(25.0)
    assert reader("device_idle.serve").read(_run(out, fed)) is None


def test_model_flops_by_hand():
    per_layer = 2 * DEC.layer_params() * 2
    head = 2 * 64 * 256
    attn = 4 * 2 * 4 * 16
    fed = {"kind": "serve", "prefill_lens": [3], "decode_ctx": [4, 5],
           "decode_tokens": 2, "decode_rows": 1}
    assert serve_flops(DEC, fed) == per_layer * 3 + head + attn * 6 \
        + (per_layer + head) * 2 + attn * 9
    tf = {"kind": "train", "steps": 2, "rows": 2, "seq": 5}
    n = DEC.layer_params() * 2 + 64 * 256
    assert train_flops(DEC, tf) == 6 * n * 16 + 12 * 2 * 4 * 16 * 2 * 2 * 10
    out = {"window_s": 1.0}
    mfu = reader("mfu.train").read(_run(out, tf))
    assert mfu == pytest.approx(100 * train_flops(DEC, tf) / 989e12)


def test_roofline_is_bound_over_device_time_and_silent_without_it():
    fed = {"kind": "serve", "prefill_lens": [1024], "decode_ctx": [],
           "decode_tokens": 0, "decode_rows": 1}
    from portbench.work import module
    fa = module("flash_attention")
    flops, nbytes = fa.work(fa.calls(DEC, fed)[0])
    bound = 2 * max(flops / 989e12, nbytes / 3.35e12)     # two layers
    run = _run({"window_s": 1.0}, fed,
               {"busy_s": 1.0, "by_class": {"flash_attention": 4 * bound}})
    assert reader("flash_attention_roofline").read(run) == pytest.approx(25.0)
    run["trace"]["by_class"] = {}
    assert reader("flash_attention_roofline").read(run) is None
    assert reader("flash_attention_roofline").read(_run({"window_s": 1.0}, fed)) \
        is None


def test_every_metric_has_a_reader_and_names_keep_the_rules():
    import re
    bench = specs.benchmark()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"])
        assert hasattr(reader(m["name"]), "read")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        # every cell that reports the metric reports what it moves
        assert set(m["workloads"]) <= set(moved.get("workloads",
                                                     m["workloads"]))
    for w in bench["workloads"]:
        assert name.match(w["name"])
        cell = specs.cell(w["name"], bench)
        assert specs.metrics_of(w["name"], True, bench)
        assert {m["name"] for m in specs.metrics_of(w["name"], False, bench)} \
            >= {"setup_s"}
        assert cell.spec.n_layers > 0
