"""The port's model serve path against the JAX package's, on the CPU.

The JAX parameters (``jax.random.key(0)``) are carried into the port with
``params_from_jax``; the same prompts and tokens, made with numpy, go
through ``prefill_step`` and a run of ``decode_step`` calls on both sides,
for dense architectures and the SSM ``falcon-mamba-7b``.
Logits agree within atol = rtol = 1e-4 in fp32: both sides compute the
same products, but XLA:CPU and PyTorch sum in other orders.  The decode
caches agree on every valid slot; an int8 cache may differ by one
quantisation step where the two sides round an element on either side of
a half.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from numpy.testing import assert_allclose

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax
from repro_torch.models import build_model
from repro_torch.models.transformer import init_decode_cache, layer_cache
from repro_torch.tree import leaves_with_path

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["gemma3-27b", "minitron-4b", "mistral-large-123b",
         "falcon-mamba-7b"]


def _both(arch):
    jcfg = jax_smoke_config(arch)
    tcfg = smoke_config(arch)
    assert vars(jcfg) == vars(tcfg)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jmodel, jparams, build_model(tcfg, "cpu"), tparams


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _valid_slots(cache_j, cache_t, cfg, lens):
    """Every layer's cache, on the slots ``[0, min(len, size))`` of each
    row (a Mamba layer's conv window and state whole), as (layer, name,
    jax array, port array, scale or None)."""
    n_layers = cfg.n_layers
    for i in range(n_layers):
        lj = layer_cache(jax.tree.map(lambda a: torch.tensor(
            np.asarray(a, np.float32)), cache_j), cfg, i)
        lt = layer_cache(cache_t, cfg, i)
        if "h" in lt:
            for b in range(len(lens)):
                for name in ("conv", "h"):
                    yield i, name, lj[name][b].numpy(), _np(lt[name][b]), None
            continue
        for b, n in enumerate(lens):
            size = lt["k"].shape[2]
            m = min(int(n), size)
            for name in ("k", "v"):
                scale = lt.get(f"{name}_scale")
                yield (i, name, lj[name][b, :, :m].numpy(),
                       _np(lt[name][b, :, :m]),
                       None if scale is None else _np(scale[b, :, :m]))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _both(arch)
    rng = np.random.default_rng(3)
    B, T, max_len, steps = 2, 12, 40, 10
    prompt = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)

    lj, cj = jmodel.prefill_step(jparams, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    lt, ct = tmodel.prefill_step(tparams, {"tokens": torch.from_numpy(prompt)},
                                 max_len=max_len)
    assert lt.shape == (B, tcfg.vocab_size)
    assert_allclose(_np(lt), np.asarray(lj), **TOL)

    # ragged rows: row 1 resumes at 9, so slots 9..11 of its prefill are
    # stale until decode overwrites them; both rows run past the smoke
    # window of 16, so the local layers' rings wrap
    lens = np.array([T, 9], np.int32)
    decode = jax.jit(jmodel.decode_step)
    for _ in range(steps):
        tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        lj, cj = decode(jparams, cj, jnp.asarray(tok), jnp.asarray(lens))
        lt, ct = tmodel.decode_step(tparams, ct, torch.from_numpy(tok),
                                    torch.from_numpy(lens))
        assert_allclose(_np(lt), np.asarray(lj), **TOL)
        lens = lens + 1
    assert max(lens) > (tcfg.sliding_window or 0)

    checked = 0
    for i, name, a, b, scale in _valid_slots(cj, ct, tcfg, lens):
        if scale is None:
            assert_allclose(b, a, err_msg=f"layer {i} {name}", **TOL)
        else:
            # int8: at most one quantisation step apart
            assert np.abs(a - b).max() <= 1, f"layer {i} {name}"
            assert np.mean(a != b) < 0.01, f"layer {i} {name}"
        checked += 1
    assert checked == tcfg.n_layers * B * 2


def test_vision_patch_embeds_are_spliced_as_jax_does():
    # pixtral-12b's frontend is stubbed in both packages: precomputed patch
    # embeddings replace the first n_patches scaled token embeddings
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _both("pixtral-12b")
    assert tcfg.frontend == "vision" and tcfg.n_patches == 8
    rng = np.random.default_rng(8)
    B, T, max_len = 2, 12, 40
    prompt = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    patches = rng.standard_normal((B, tcfg.n_patches, tcfg.d_model)
                                  ).astype(np.float32)

    lj, cj = jmodel.prefill_step(
        jparams, {"tokens": jnp.asarray(prompt),
                  "patch_embeds": jnp.asarray(patches)}, max_len=max_len)
    lt, ct = tmodel.prefill_step(
        tparams, {"tokens": torch.from_numpy(prompt),
                  "patch_embeds": torch.from_numpy(patches)}, max_len=max_len)
    assert_allclose(_np(lt), np.asarray(lj), **TOL)
    lens = np.full(B, T, np.int32)
    checked = 0
    for i, name, a, b, _ in _valid_slots(cj, ct, tcfg, lens):
        assert_allclose(b, a, err_msg=f"layer {i} {name}", **TOL)
        checked += 1
    assert checked == tcfg.n_layers * B * 2

    # the splice took effect: without the patches both packages give other
    # logits, by far more than the tolerance
    lj_plain, _ = jmodel.prefill_step(jparams, {"tokens": jnp.asarray(prompt)},
                                      max_len=max_len)
    lt_plain, _ = tmodel.prefill_step(
        tparams, {"tokens": torch.from_numpy(prompt)}, max_len=max_len)
    assert_allclose(_np(lt_plain), np.asarray(lj_plain), **TOL)
    assert np.abs(_np(lt) - np.asarray(lj_plain)).max() > 0.1


def test_decode_cache_layout_matches_jax():
    from repro.models.transformer import init_decode_cache as jax_cache
    cfg = smoke_config("gemma3-27b")
    tc = init_decode_cache(cfg, 3, 40, "cpu")
    jc = jax_cache(jax_smoke_config("gemma3-27b"), 3, 40)
    assert set(tc) == set(jc)
    for head in tc:
        assert len(tc[head]) == len(jc[head])
        for t_layer, j_layer in zip(tc[head], jc[head]):
            assert {k: tuple(v.shape) for k, v in t_layer.items()} == \
                {k: tuple(v.shape) for k, v in j_layer.items()}


def test_ssm_decode_cache_layout_matches_jax():
    from repro.models.transformer import init_decode_cache as jax_cache
    for scan in (True, False):   # groups, and every layer in the tail
        cfg = smoke_config("falcon-mamba-7b").replace(scan_layers=scan)
        tc = init_decode_cache(cfg, 3, 40, "cpu")
        jc = jax_cache(jax_smoke_config("falcon-mamba-7b").replace(
            scan_layers=scan), 3, 40)
        assert set(tc) == set(jc)
        for head in tc:
            assert len(tc[head]) == len(jc[head])
            for t_layer, j_layer in zip(tc[head], jc[head]):
                assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                        for k, v in t_layer.items()} == \
                    {k: (tuple(v.shape), str(v.dtype))
                     for k, v in j_layer.items()}


def test_ssm_layers_in_the_tail_match_jax():
    # scan_layers=False puts every layer in the tail: the other cache path
    jcfg = jax_smoke_config("falcon-mamba-7b").replace(scan_layers=False)
    tcfg = smoke_config("falcon-mamba-7b").replace(scan_layers=False)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(1))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    tmodel = build_model(tcfg, "cpu")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, tcfg.vocab_size, (2, 7)).astype(np.int32)
    lj, cj = jmodel.prefill_step(jparams, {"tokens": jnp.asarray(prompt)})
    lt, ct = tmodel.prefill_step(tparams, {"tokens": torch.from_numpy(prompt)})
    assert_allclose(_np(lt), np.asarray(lj), **TOL)
    assert "groups" not in ct and len(ct["tail"]) == tcfg.n_layers
    lens = np.array([7, 7], np.int32)
    for _ in range(3):
        tok = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
        lj, cj = jmodel.decode_step(jparams, cj, jnp.asarray(tok),
                                    jnp.asarray(lens))
        lt, ct = tmodel.decode_step(tparams, ct, torch.from_numpy(tok),
                                    torch.from_numpy(lens))
        assert_allclose(_np(lt), np.asarray(lj), **TOL)
        lens = lens + 1
    for i, name, a, b, _ in _valid_slots(cj, ct, tcfg, lens):
        assert_allclose(b, a, err_msg=f"layer {i} {name}", **TOL)


def test_params_from_jax_keeps_the_mamba_fp32_leaves():
    cfg = jax_smoke_config("falcon-mamba-7b").replace(dtype="bfloat16")
    jparams = jax_build_model(cfg).init(jax.random.key(0))
    tparams = params_from_jax(smoke_config("falcon-mamba-7b").replace(
        dtype="bfloat16"), jax.tree.map(np.asarray, jparams), "cpu")
    for i, layer in enumerate(tparams["layers"]):
        jlayer = jparams["groups"][0]["mamba"]
        for name, leaf in layer["mamba"].items():
            want = torch.float32 if name in ("A_log", "Dp") else torch.bfloat16
            assert leaf.dtype == want, name
            assert np.array_equal(leaf.float().numpy(),
                                  np.asarray(jlayer[name][i], np.float32)), name


def test_embedding_scale_rounds_to_the_model_dtype():
    from repro_torch.models.transformer import embed_tokens
    cfg = smoke_config("gemma3-27b").replace(dtype="bfloat16", d_model=5376,
                                             vocab_size=7)
    table = np.random.default_rng(0).standard_normal((7, 5376))
    jtable = jnp.asarray(table, jnp.bfloat16)
    tok = np.array([[3, 0, 6]], np.int32)
    # the JAX forward's embedding, transformer.py:204-206
    want = jnp.take(jtable, jnp.asarray(tok), axis=0).astype(jnp.bfloat16) \
        * jnp.asarray(cfg.d_model ** 0.5, jnp.bfloat16)
    got = embed_tokens({"embed": {"tok": torch.from_numpy(
        np.asarray(jtable, np.float32)).to(torch.bfloat16)}}, cfg,
        torch.from_numpy(tok))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    # sqrt(5376) = 73.32 is 73.5 in bfloat16, and the product used it
    assert float(torch.tensor(5376 ** 0.5, dtype=torch.bfloat16)) == 73.5


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "grok-1-314b"])
def test_moe_config_builds_with_the_parameter_shapes_of_params_from_jax(arch):
    cfg = smoke_config(arch)
    got = build_model(cfg, "cpu").init(0)
    jparams = jax_build_model(jax_smoke_config(arch)).init(jax.random.key(0))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    shapes = [[(path, tuple(t.shape), t.dtype)
               for path, t in leaves_with_path(tree)] for tree in (got, want)]
    assert shapes[0] == shapes[1]
    assert all("ffn" in layer and "router" in layer["ffn"]
               for layer in got["layers"])


def test_prefill_longer_than_the_cache_keeps_the_tail_in_ring_order():
    # T = 12 > max_len = 10: every layer keeps the last 10 positions, rolled
    # so that position p sits at slot p % 10
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _both("minitron-4b")
    prompt = np.random.default_rng(5).integers(
        0, tcfg.vocab_size, (1, 12)).astype(np.int32)
    lj, cj = jmodel.prefill_step(jparams, {"tokens": jnp.asarray(prompt)},
                                 max_len=10)
    lt, ct = tmodel.prefill_step(tparams, {"tokens": torch.from_numpy(prompt)},
                                 max_len=10)
    assert_allclose(_np(lt), np.asarray(lj), **TOL)
    for layer_j, layer_t in zip(cj["groups"], ct["groups"]):
        for name in ("k", "v"):
            assert tuple(layer_t[name].shape) == layer_j[name].shape
            assert_allclose(_np(layer_t[name]), np.asarray(layer_j[name]),
                            **TOL)


def test_params_from_jax_carries_bfloat16_bits():
    from repro_torch.interop import tensor_from_numpy
    a = jnp.asarray(np.random.default_rng(6).standard_normal((3, 5)),
                    jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(a), torch.device("cpu"))
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), np.asarray(a, np.float32))
