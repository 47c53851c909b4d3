"""The port's encoder-decoder (``whisper-tiny``) against the JAX package's,
on the CPU.

The JAX parameters (``jax.random.key(0)``) are carried into the port with
``params_from_jax``; the same frames and tokens, made with numpy, go
through both packages at whisper's smoke config (fp32 unless a case says
otherwise): the encoder, ``train``-mode logits with frames and without
them (the cross-attention step is then skipped), ``prefill_step`` with
frames and a run of ``decode_step`` calls with ragged cache lengths, the
loss and every gradient leaf, and ``train_step`` over two microbatches.
Logits, the encoder's output and every valid K/V slot agree within
atol = rtol = 1e-4 (fp32 sums taken in other orders by XLA:CPU and
PyTorch), the loss within rtol 1e-5 and each gradient leaf within rtol
1e-4 / atol 1e-5, as ``tests/test_torch_train.py`` holds them.

A bf16 model fed fp32 frames runs its encoder in fp32 on both sides (JAX
promotes ``frames + pos``; the port mirrors its promotion of fp32
activations against bf16 weights): the encoder's output within 1e-4, the
bf16 logits within 2e-2 in norm.  The reference trainer's
batches carry tokens alone (ROADMAP C13): on both packages the cross
and encoder leaves then get zero gradients.
"""
import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from numpy.testing import assert_allclose

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models.model import _logits as jax_logits
from repro.models.transformer import encoder_forward as jax_encoder
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_decode_cache as jax_cache
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import SyntheticLM as JaxSyntheticLM
from repro_torch.configs import get_config, smoke_config
from repro_torch.interop import params_from_jax, train_state_from_jax
from repro_torch.models import build_model
from repro_torch.models.transformer import (encoder_forward, forward,
                                            init_decode_cache, lm_logits)
from repro_torch.serve import ServeEngine
from repro_torch.train import DataConfig, SyntheticLM
from repro_torch.tree import leaves, leaves_with_path
from torch_trees import assert_trees_close

ARCH = "whisper-tiny"
TOL = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@functools.lru_cache(maxsize=None)
def _jax_side(items):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **dict(items))
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.key(0))
    return jcfg, jmodel, jstate, jax.tree.map(np.asarray, jstate)


def _both(**kw):
    """Both models at whisper's smoke config (``kw`` replaced), the port's
    state a fresh copy of the JAX one."""
    jcfg, jmodel, jstate, tree = _jax_side(tuple(sorted(kw.items())))
    tcfg = dataclasses.replace(smoke_config(ARCH), **kw)
    assert vars(jcfg) == vars(tcfg)
    tstate = train_state_from_jax(tcfg, tree, "cpu")
    return jcfg, tcfg, jmodel, jstate, build_model(tcfg, "cpu"), tstate


def _frames(cfg, B=2, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_positions, cfg.d_model)).astype(dtype)


def _tokens(cfg, B=2, T=17, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32)


def _batch(cfg, tokens, frames):
    return ({"tokens": jnp.asarray(tokens),
             "encoder_frames": jnp.asarray(frames)},
            {"tokens": torch.from_numpy(tokens),
             "encoder_frames": torch.from_numpy(frames)})


def _assert_trees_close(got, want_jax, cfg, **tol):
    want = params_from_jax(cfg, jax.tree.map(np.asarray, want_jax), "cpu")
    assert_trees_close(got, want, **tol)


# ------------------------------------------------------------- structure
def test_init_params_has_the_shapes_of_params_from_jax():
    cfg = smoke_config(ARCH)
    got = build_model(cfg, "cpu").init(0)
    jparams = jax_build_model(jax_smoke_config(ARCH)).init(jax.random.key(0))
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    shapes = [[(path, tuple(t.shape), t.dtype)
               for path, t in leaves_with_path(tree)] for tree in (got, want)]
    assert shapes[0] == shapes[1]
    assert len(got["encoder"]["layers"]) == cfg.n_encoder_layers
    assert all("cross" in layer and "norm_cross" in layer
               for layer in got["layers"])
    assert not any("cross" in layer for layer in got["encoder"]["layers"])


def test_full_config_holds_the_reference_parameters():
    # whisper-tiny at full size: the port's tree has the shapes and types
    # of the JAX package's (traced, not drawn).  ModelConfig.n_params counts
    # the decoder's 448 x 384 position table twice and leaves out each
    # decoder layer's norm_cross and the two final norms (ROADMAP C12)
    cfg = get_config(ARCH)
    got = build_model(cfg, "cpu").init(0)
    shapes = jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init,
                            jax.random.key(0))
    want = params_from_jax(cfg, jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes), "cpu")
    assert [(p, tuple(t.shape), t.dtype) for p, t in leaves_with_path(got)] \
        == [(p, tuple(t.shape), t.dtype) for p, t in leaves_with_path(want)]
    held = sum(t.numel() for t in leaves(got))
    assert cfg.n_params() - held == (cfg.decoder_positions
                                     - cfg.n_layers - 2) * cfg.d_model
    assert held == 41_906_304
    assert got["encoder"]["pos"].shape == (1500, 384)
    assert got["embed"]["pos"].shape == (448, 384)


def test_decode_cache_layout_matches_jax():
    cfg = smoke_config(ARCH)
    tc = init_decode_cache(cfg, 3, 40, "cpu")
    jc = jax_cache(jax_smoke_config(ARCH), 3, 40)
    assert set(tc) == set(jc) == {"tail", "enc_out"}
    assert tuple(tc["enc_out"].shape) == jc["enc_out"].shape
    assert str(tc["enc_out"].dtype).removeprefix("torch.") == \
        str(jc["enc_out"].dtype)
    for t_layer, j_layer in zip(tc["tail"], jc["tail"]):
        assert {k: tuple(v.shape) for k, v in t_layer.items()} == \
            {k: tuple(v.shape) for k, v in j_layer.items()}


# --------------------------------------------------------------- forward
def test_encoder_forward_matches_jax():
    jcfg, tcfg, _, jstate, _, tstate = _both()
    frames = _frames(tcfg)
    want = jax_encoder(jstate.params, jcfg, jnp.asarray(frames))
    got = encoder_forward(tstate.params, tcfg, torch.from_numpy(frames))
    assert got.shape == want.shape == frames.shape
    assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_frames", [True, False],
                         ids=["frames", "no-frames"])
def test_train_logits_match_jax(with_frames):
    jcfg, tcfg, _, jstate, _, tstate = _both()
    tokens = _tokens(tcfg)
    frames = _frames(tcfg) if with_frames else None
    want, _, _ = jax_forward(
        jstate.params, jcfg, jnp.asarray(tokens), mode="train",
        encoder_frames=None if frames is None else jnp.asarray(frames))
    got, _, _ = forward(
        tstate.params, tcfg, torch.from_numpy(tokens), mode="train",
        encoder_frames=None if frames is None else torch.from_numpy(frames))
    assert got.shape == want.shape
    assert_allclose(_np(got), np.asarray(want), **TOL)
    if with_frames:
        # the cross step took effect: without the frames both packages
        # give other logits, by far more than the tolerance
        plain, _, _ = forward(tstate.params, tcfg, torch.from_numpy(tokens),
                              mode="train")
        assert np.abs(_np(got) - _np(plain)).max() > 0.1


def test_prefill_and_decode_match_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both()
    jparams, tparams = jstate.params, tstate.params
    B, T, max_len, steps = 2, 12, 40, 10
    prompt = _tokens(tcfg, B, T, seed=3)
    jb, tb = _batch(tcfg, prompt, _frames(tcfg, B, seed=4))
    lj, cj = jmodel.prefill_step(jparams, jb, max_len=max_len)
    lt, ct = tmodel.prefill_step(tparams, tb, max_len=max_len)
    assert lt.shape == (B, tcfg.vocab_size)
    assert_allclose(_np(lt), np.asarray(lj), **TOL)
    assert set(ct) == set(cj) == {"tail", "enc_out"}
    assert_allclose(_np(ct["enc_out"]), np.asarray(cj["enc_out"]), **TOL)

    # ragged rows: row 1 resumes at 9, so slots 9..11 of its prefill are
    # stale until decode overwrites them
    rng = np.random.default_rng(5)
    lens = np.array([T, 9], np.int32)
    decode = jax.jit(jmodel.decode_step)
    for _ in range(steps):
        tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        lj, cj = decode(jparams, cj, jnp.asarray(tok), jnp.asarray(lens))
        lt, ct = tmodel.decode_step(tparams, ct, torch.from_numpy(tok),
                                    torch.from_numpy(lens))
        assert_allclose(_np(lt), np.asarray(lj), **TOL)
        lens = lens + 1
    assert_allclose(_np(ct["enc_out"]), np.asarray(cj["enc_out"]), **TOL)
    checked = 0
    for i, (layer_j, layer_t) in enumerate(zip(cj["tail"], ct["tail"])):
        for b, n in enumerate(lens):
            for name in ("k", "v"):
                assert_allclose(_np(layer_t[name][b, :, :n]),
                                np.asarray(layer_j[name][b, :, :n]),
                                err_msg=f"layer {i} {name}", **TOL)
                checked += 1
    assert checked == tcfg.n_layers * B * 2


def _teacher_forced_and_decoded(side, cfg, params, model, tokens, frames):
    """(logits of the last position from a teacher-forced ``train``
    forward, logits of decoding that position after a prefill of the
    others), on one package."""
    T = tokens.shape[1]
    if side == "jax":
        tok, fr = jnp.asarray(tokens), jnp.asarray(frames)
        hid, _, _ = jax_forward(params, cfg, tok, mode="train",
                                encoder_frames=fr, _return_hidden=True)
        want = jax_logits(params, cfg, hid[:, -1:, :])[:, 0]
        lens = jnp.full((tok.shape[0],), T - 1, jnp.int32)
    else:
        tok, fr = torch.from_numpy(tokens), torch.from_numpy(frames)
        hid, _, _ = forward(params, cfg, tok, mode="train",
                            encoder_frames=fr, return_hidden=True)
        want = lm_logits(params, cfg, hid[:, -1:, :])[:, 0]
        lens = torch.full((tok.shape[0],), T - 1, dtype=torch.int32)
    _, cache = model.prefill_step(
        params, {"tokens": tok[:, :T - 1], "encoder_frames": fr})
    got, _ = model.decode_step(params, cache, tok[:, T - 1:T], lens)
    return _np(want), _np(got)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_decode_after_prefill_equals_the_teacher_forced_forward(side):
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both()
    tokens, frames = _tokens(tcfg, 2, 12, seed=6), _frames(tcfg, seed=7)
    if side == "jax":
        want, got = _teacher_forced_and_decoded(
            side, jcfg, jstate.params, jmodel, tokens, frames)
    else:
        want, got = _teacher_forced_and_decoded(
            side, tcfg, tstate.params, tmodel, tokens, frames)
    assert_allclose(got, want, **TOL)


def test_bf16_model_fed_fp32_frames_runs_its_encoder_in_fp32():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both(dtype="bfloat16")
    frames = _frames(tcfg, seed=8)           # fp32, as tests/test_archs.py
    prompt = _tokens(tcfg, 2, 12, seed=9)
    jenc = jax_encoder(jstate.params, jcfg, jnp.asarray(frames))
    tenc = encoder_forward(tstate.params, tcfg, torch.from_numpy(frames))
    assert jenc.dtype == jnp.float32 and tenc.dtype == torch.float32
    # fp32 products of the bf16 weights on both sides: fp32's tolerance
    assert_allclose(_np(tenc), np.asarray(jenc), **TOL)
    jb, tb = _batch(tcfg, prompt, frames)
    lj, cj = jmodel.prefill_step(jstate.params, jb, max_len=40)
    lt, ct = tmodel.prefill_step(tstate.params, tb, max_len=40)
    # the prefill's cache keeps the fp32 encoder output; its K/V are bf16
    assert cj["enc_out"].dtype == jnp.float32
    assert ct["enc_out"].dtype == torch.float32
    assert ct["tail"][0]["k"].dtype == torch.bfloat16
    _bf16_close(lt, lj)
    tok = np.array([[3], [7]], np.int32)
    lens = np.array([12, 12], np.int32)
    lj, _ = jmodel.decode_step(jstate.params, cj, jnp.asarray(tok),
                               jnp.asarray(lens))
    lt, _ = tmodel.decode_step(tstate.params, ct, torch.from_numpy(tok),
                               torch.from_numpy(lens))
    _bf16_close(lt, lj)


def _bf16_close(got, want):
    """bf16 logits within 2e-2 of JAX's in norm.  The decoder rounds its
    bf16 products and activations once each on both sides, but XLA:CPU and
    PyTorch sum in other orders, so an element may land one bf16 step
    away (0.125 at logits of 16-32); the error is 5e-3-6e-3 in norm with
    frames and without them."""
    g, w = _np(got), np.asarray(want, np.float32)
    assert np.isfinite(g).all()
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= 2e-2


# -------------------------------------------------------------- training
def test_loss_and_every_gradient_leaf_match_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both()
    jb, tb = _batch(tcfg, _tokens(tcfg, 4, 17, seed=10),
                    _frames(tcfg, 4, seed=11))
    jl, jg = jmodel.grad_step(jstate.params, jb)
    tl, tg = tmodel.grad_step(tstate.params, tb)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    _assert_trees_close(tg, jg, tcfg, rtol=1e-4, atol=1e-5)
    # the gradient reaches the encoder and the cross-attention
    assert float(tg["encoder"]["layers"][0]["attn"]["wq"].abs().sum()) > 0
    assert float(tg["encoder"]["pos"].abs().sum()) > 0
    for layer in tg["layers"]:
        for name in ("wq", "wk", "wv", "wo"):
            assert float(layer["cross"][name].abs().sum()) > 0, name


def test_remat_passes_the_encoder_output_to_each_recomputed_layer():
    """Under remat each decoder layer is recomputed with the encoder's
    output as an argument: the same loss and gradients, the encoder's
    included, as without remat."""
    cfg = smoke_config(ARCH)
    params = build_model(cfg, "cpu").init(0)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, 17, seed=12)),
             "encoder_frames": torch.from_numpy(_frames(cfg, seed=13))}
    out = {}
    for remat in (False, True):
        model = build_model(dataclasses.replace(cfg, remat=remat), "cpu")
        out[remat] = model.grad_step(params, batch)
    assert torch.equal(out[True][0], out[False][0])
    for (path, a), (_, b) in zip(leaves_with_path(out[True][1]),
                                 leaves_with_path(out[False][1]),
                                 strict=True):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7), path
    assert float(out[True][1]["encoder"]["final_norm"]["scale"].abs().sum()) > 0


def test_two_microbatch_train_step_matches_jax():
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both(n_microbatches=2)
    jstep = jax.jit(jmodel.train_step)
    for step in range(2):
        jb, tb = _batch(tcfg, _tokens(tcfg, 4, 17, seed=20 + step),
                        _frames(tcfg, 4, seed=30 + step))
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tmodel.train_step(tstate, tb)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    _assert_trees_close(tstate.params, jstate.params, tcfg, rtol=1e-4,
                        atol=1e-5)


def test_trainer_batches_without_frames_leave_the_encoder_untrained():
    # ROADMAP C13: the reference trainer's batches hold tokens alone, so
    # the cross step is skipped and the cross and encoder leaves get zero
    # gradients, on both packages
    jcfg, tcfg, jmodel, jstate, tmodel, tstate = _both()
    data = dict(vocab_size=tcfg.vocab_size, seq_len=16, global_batch=2,
                seed=0)
    jbatch = JaxSyntheticLM(JaxDataConfig(**data)).batch(0)
    tbatch = SyntheticLM(DataConfig(**data)).batch(0)
    assert set(jbatch) == set(tbatch) == {"tokens"}
    np.testing.assert_array_equal(jbatch["tokens"], tbatch["tokens"])
    jl, jg = jmodel.grad_step(jstate.params, jax.tree.map(jnp.asarray,
                                                          jbatch))
    tl, tg = tmodel.grad_step(tstate.params, {
        "tokens": torch.from_numpy(tbatch["tokens"])})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    jg = params_from_jax(tcfg, jax.tree.map(np.asarray, jg), "cpu")
    for grads in (jg, tg):
        untrained = [grads["encoder"]] + [
            {k: layer[k] for k in ("cross", "norm_cross")}
            for layer in grads["layers"]]
        assert all(float(g.abs().max()) == 0 for g in leaves(untrained))
        assert all(float(layer["attn"]["wq"].abs().max()) > 0
                   for layer in grads["layers"])


# ----------------------------------------------------------------- serve
def test_serve_engine_refuses_the_encoder_decoder():
    # its admission prefills tokens alone, as the JAX package's engine does
    cfg = smoke_config(ARCH)
    params = build_model(cfg, "cpu").init(0)
    with pytest.raises(ValueError, match="encoder_frames"):
        ServeEngine(cfg, params, device="cpu")
