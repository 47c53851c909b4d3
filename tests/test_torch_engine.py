"""The port's continuous-batching engine: the serving cases of
``tests/test_ft.py``, and identical greedy token streams beside the JAX
package's engine over a seeded workload, on the CPU.

The parity workload shrinks the JAX parameters' token embedding by 20×
before both engines get them: at random init the scaled embedding
dominates the residual stream and greedy decoding repeats the prompt's
last token, which two engines would agree on whatever their layers did.
"""
import numpy as np
import jax
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import build_model
from repro_torch.serve import ServeEngine
from repro_torch.serve.engine import _splice_cache


def tiny_cfg():
    return smoke_config("minitron-4b").replace(
        n_layers=2, d_model=32, d_ff=64, vocab_size=97, n_heads=2,
        n_kv_heads=2, head_dim=16, kv_cache_dtype="bfloat16")


def test_engine_batched_decode():
    cfg = tiny_cfg()
    params = build_model(cfg, "cpu").init(0)
    eng = ServeEngine(cfg, params, max_batch=3, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size, 8), max_new_tokens=5)
            for _ in range(5)]
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == 5 for r in reqs)


def test_engine_matches_sequential_decode():
    """Continuous batching must not change greedy outputs."""
    cfg = tiny_cfg()
    model = build_model(cfg, "cpu")
    params = model.init(1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 6) for _ in range(3)]

    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu")
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
    eng.run_until_drained()

    for p, r in zip(prompts, reqs):
        logits, cache = model.prefill_step(
            params, {"tokens": torch.as_tensor(p[None, :], dtype=torch.int32)},
            max_len=64)
        toks = [int(torch.argmax(logits[0]))]
        cl = torch.tensor([len(p)], dtype=torch.int32)
        for _ in range(3):
            logits, cache = model.decode_step(
                params, cache, torch.tensor([[toks[-1]]], dtype=torch.int32),
                cl)
            toks.append(int(torch.argmax(logits[0])))
            cl = cl + 1
        assert r.out_tokens == toks


def test_engine_token_streams_match_jax():
    arch = "gemma3-27b"
    jcfg = jax_smoke_config(arch)
    jparams = dict(jax_build_model(jcfg).init(jax.random.key(0)))
    jparams["embed"] = {"tok": jparams["embed"]["tok"] * 0.05}
    tparams = params_from_jax(smoke_config(arch),
                              jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    # prompts of 5 and 21 tokens (two lengths: the JAX engine compiles a
    # prefill per length) and 12 new ones: past the smoke window of 16, so
    # prefill rolls the local layers' rings and decode wraps them
    prompts = [rng.integers(0, jcfg.vocab_size, n) for n in (5, 21) * 3]

    jeng = JaxServeEngine(jcfg, jparams, max_batch=4, max_len=64)
    jreqs = [jeng.submit(p, max_new_tokens=12) for p in prompts]
    jeng.run_until_drained()
    teng = ServeEngine(smoke_config(arch), tparams, max_batch=4, max_len=64,
                       device="cpu")
    treqs = [teng.submit(p, max_new_tokens=12) for p in prompts]
    teng.run_until_drained()

    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done and len(r.out_tokens) == 12 for r in treqs)
    # a workload whose streams all repeat one token would prove little
    assert sum(len(set(r.out_tokens)) > 1 for r in treqs) >= 3
    np.testing.assert_array_equal(teng.cache_len.numpy(),
                                  np.asarray(jeng.cache_len))


def _ssm_engines(prompts, new_tokens):
    """The JAX and the port's engine, with the same smoke falcon-mamba-7b
    weights, each run over ``prompts``."""
    arch = "falcon-mamba-7b"
    jcfg = jax_smoke_config(arch)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    tparams = params_from_jax(smoke_config(arch),
                              jax.tree.map(np.asarray, jparams), "cpu")
    jeng = JaxServeEngine(jcfg, jparams, max_batch=4, max_len=64)
    jreqs = [jeng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    teng = ServeEngine(smoke_config(arch), tparams, max_batch=4, max_len=64,
                       device="cpu")
    treqs = [teng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    return jeng, jreqs, teng, treqs


def test_engine_ssm_token_streams_match_jax():
    # falcon-mamba-7b does not scale its embedding: its greedy streams vary
    # at random init without shrinking it
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 503, n) for n in (5, 21, 9) * 2]
    jeng, jreqs, teng, treqs = _ssm_engines(prompts, 12)
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done and len(r.out_tokens) == 12 for r in treqs)
    assert sum(len(set(r.out_tokens)) > 1 for r in treqs) >= 3
    # cache_len advances for SSM slots too, as in the JAX engine
    np.testing.assert_array_equal(teng.cache_len.numpy(),
                                  np.asarray(jeng.cache_len))


def test_engine_ssm_short_prompt_keeps_the_reference_conv_history():
    # A 2-token prompt is shorter than the conv window's 3 rows of history:
    # prefill keeps its 2 rows and the splice pads the third with zeros
    # *after* them, so decode reads a zero as the newest input (ROADMAP
    # C5).  The port keeps this for parity with the JAX engine.
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 503, 2), rng.integers(0, 503, 7)]
    jeng, jreqs, teng, treqs = _ssm_engines(prompts, 6)
    jeng._admit()
    teng._admit()
    for jlayer, tlayer in zip(jeng.cache["groups"], teng.cache["groups"]):
        conv = tlayer["conv"]                    # [n_groups, B, 3, Di]
        assert conv[:, 0, :2].abs().sum() > 0 and conv[:, 0, 2].eq(0).all()
        for name in ("conv", "h"):
            np.testing.assert_allclose(tlayer[name].numpy(),
                                       np.asarray(jlayer[name]),
                                       atol=1e-4, rtol=1e-4)
    jeng.run_until_drained()
    teng.run_until_drained()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]


def test_splice_pads_and_slices_to_the_buffer():
    buf = {"groups": [{"k": torch.zeros((2, 3, 4, 5))}],
           "tail": [{"k": torch.zeros((3, 4, 5))}]}
    new = {"groups": [{"k": torch.ones((2, 1, 2, 7))}],
           "tail": [{"k": torch.ones((1, 6, 5))}]}
    _splice_cache(buf, new, 1)
    g = buf["groups"][0]["k"]
    assert g[:, 1, :2, :].eq(1).all() and g[:, 1, 2:, :].eq(0).all()
    assert g[:, 0].eq(0).all() and g[:, 2].eq(0).all()
    t = buf["tail"][0]["k"]
    assert t[1].eq(1).all() and t[0].eq(0).all() and t[2].eq(0).all()


def test_temperature_sampling_is_seeded():
    cfg = tiny_cfg()
    params = build_model(cfg, "cpu").init(0)
    prompt = np.arange(8) % cfg.vocab_size

    def run(seed):
        eng = ServeEngine(cfg, params, max_batch=2, max_len=32,
                          temperature=1.0, seed=seed, device="cpu")
        req = eng.submit(prompt, max_new_tokens=6)
        eng.run_until_drained()
        return req.out_tokens

    assert run(3) == run(3)
    assert all(0 <= t < cfg.vocab_size for t in run(4))


def test_launcher_serves_the_ssm_smoke_config_on_cpu(capsys):
    reqs = serve_launcher.main(["--arch", "falcon-mamba-7b", "--preset",
                                "smoke", "--device", "cpu", "--requests", "3",
                                "--max-new", "4"])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


def test_launcher_serves_the_smoke_config_on_cpu(capsys):
    reqs = serve_launcher.main(["--arch", "gemma3-27b", "--preset", "smoke",
                                "--device", "cpu", "--requests", "3",
                                "--max-new", "4"])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
