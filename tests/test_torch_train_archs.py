"""Per-architecture training smoke tests of the port, on the CPU: the case
``TestSmoke.test_forward_and_train_step`` of ``tests/test_archs.py`` for
every architecture (the dense family, the VLM backbone, the MoE family,
the SSM, the hybrid and the encoder-decoder, fed frames as that case
feeds them), with the initial loss, the MoE router's load-balance term
included, held to the JAX package's from the same parameters (rtol 1e-5).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.interop import train_state_from_jax
from repro_torch.models import build_model

TRAINED = ["falcon-mamba-7b", "gemma-7b", "gemma3-27b",
           "granite-moe-1b-a400m", "grok-1-314b", "jamba-1.5-large-398b",
           "minitron-4b", "mistral-large-123b", "pixtral-12b",
           "whisper-tiny"]


def make_batch(cfg, rng, B=2, T=16):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(
        np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        batch["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_positions, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", TRAINED)
def test_forward_and_train_step(arch):
    cfg = smoke_config(arch)
    jmodel = jax_build_model(jax_smoke_config(arch))
    jstate = jmodel.init_train_state(jax.random.key(0))
    model = build_model(cfg, "cpu")
    state = train_state_from_jax(cfg, jax.tree.map(np.asarray, jstate), "cpu")
    batch = make_batch(cfg, np.random.default_rng(0))
    loss_fn = jax.jit(jmodel.loss_fn)
    want = float(loss_fn(jstate.params, jax.tree.map(jnp.asarray, batch)))
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss0 = model.loss_fn(state.params, batch)
    assert np.isfinite(float(loss0)), f"{arch}: non-finite initial loss"
    assert float(loss0) == pytest.approx(want, rel=1e-5)
    state, metrics = model.train_step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    # one more step must change the loss (optimizer actually applied)
    state, m2 = model.train_step(state, batch)
    assert float(m2["loss"]) != float(metrics["loss"])
    assert int(m2["step"]) == 2



def test_every_architecture_trains():
    assert sorted(TRAINED) == sorted(ARCHS)
