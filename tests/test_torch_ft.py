"""The port's fault-tolerant training driver on the CPU: the five training
cases of ``tests/test_ft.py`` (train → crash → restore → identical
continuation; straggler sealing; elastic resize), the launcher's flow, and
the JAX package's ``FTTrainer`` as the reference: from the same initial
state (carried across with ``train_state_from_jax``), the two drivers give
the same losses (rtol 1e-5), step after step, through a straggler and a
host failure.
"""
import os

import numpy as np
import pytest
import jax
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.runtime.ft import FTConfig as JaxFTConfig
from repro.runtime.ft import FTTrainer as JaxFTTrainer
from repro_torch.configs import smoke_config
from repro_torch.interop import train_state_from_jax
from repro_torch.launch import train as train_launcher
from repro_torch.runtime.ft import FTConfig, FTTrainer, deterministic
from repro_torch.train.delta_sync import DeltaAggregator, GradDelta


def tiny_cfg(smoke=smoke_config):
    return smoke("minitron-4b").replace(
        n_layers=2, d_model=32, d_ff=64, vocab_size=97, n_heads=2,
        n_kv_heads=2, head_dim=16)


def trainer(ft):
    return FTTrainer(tiny_cfg(), ft, device="cpu")


class TestFTTraining:
    def test_loss_decreases(self):
        tr = trainer(FTConfig(n_hosts=2, global_batch=8, seq_len=32,
                              ckpt_every=100))
        losses = tr.train_steps(30)
        assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1

    def test_crash_restore_continues_identically(self):
        """Checkpoint/restart must reproduce the uninterrupted run exactly
        (same data stream, same state -> bit-equal losses)."""
        ft = FTConfig(n_hosts=3, global_batch=6, seq_len=16, ckpt_every=4)
        ref = trainer(ft)
        ref_losses = ref.train_steps(8)

        tr = trainer(ft)
        losses_a = tr.train_steps(4)   # checkpoint fires at step 4
        # simulated coordinator crash: rebuild trainer, restore from store
        tr2 = trainer(ft)
        tr2.store = tr.store
        step = tr2.restore()
        assert step == 4
        losses_b = tr2.train_steps(4)
        np.testing.assert_allclose(losses_a + losses_b, ref_losses, rtol=1e-5)
        assert losses_a + losses_b == ref_losses   # bit for bit on the CPU

    def test_restore_survives_host_loss(self):
        ft = FTConfig(n_hosts=4, global_batch=8, seq_len=16, ckpt_every=2,
                      replication=3)
        tr = trainer(ft)
        tr.train_steps(2)
        tr.crash_host(1)
        tr2 = trainer(ft)
        tr2.store = tr.store
        assert tr2.restore() == 2

    def test_straggler_sealed_out(self):
        ft = FTConfig(n_hosts=4, global_batch=8, seq_len=16,
                      quorum_frac=0.5, ckpt_every=100)
        tr = trainer(ft)
        losses = tr.train_steps(3, slow_hosts={"node2": 2})
        assert all(np.isfinite(losses))
        # late duplicate delivery must be rejected (sealed step)
        agg = DeltaAggregator(["a", "b"], quorum=1)
        g = {"w": torch.ones(2)}
        agg.offer(GradDelta("a", 0, 4, g))
        agg.seal(0)
        assert agg.offer(GradDelta("b", 0, 4, g)) is False

    def test_elastic_scale_down_continues(self):
        ft = FTConfig(n_hosts=4, global_batch=8, seq_len=16, ckpt_every=100)
        tr = trainer(ft)
        tr.train_steps(2)
        tr.elastic.fail("node3", detected_by="node0")
        losses = tr.train_steps(2)
        assert all(np.isfinite(losses))
        a = tr.elastic.current_assignment()
        assert a.dp_size == 3


def test_losses_match_jax_through_a_straggler_and_a_crash():
    kw = dict(n_hosts=3, global_batch=6, seq_len=16, ckpt_every=2,
              quorum_frac=0.5)
    jtr = JaxFTTrainer(tiny_cfg(jax_smoke_config), JaxFTConfig(**kw))
    tr = trainer(FTConfig(**kw))
    tr.state = train_state_from_jax(tr.cfg, jax.tree.map(np.asarray,
                                                         jtr.state), "cpu")
    got, want = [], []
    for t in (tr, jtr):
        out = got if t is tr else want
        out += t.train_steps(2)
        out += t.train_steps(2, slow_hosts={"node1": 1})
        t.crash_host(2)
        assert t.restore() == 4
        out += t.train_steps(2)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_launcher_flow_on_the_cpu(capsys):
    losses = train_launcher.main(["--arch", "minitron-4b", "--preset", "smoke",
                                  "--device", "cpu", "--steps", "5",
                                  "--crash-at", "3", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "restored at step 3" in out
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_trainer_and_launcher_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FTTrainer(tiny_cfg(), FTConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--arch", "minitron-4b"])


def test_deterministic_is_enforced_on_the_card_and_put_back(monkeypatch):
    """On the card the steps run with deterministic algorithms enforced
    (an operation with no deterministic version raises, it does not only
    warn) and a fixed cuBLAS workspace; both are put back after.  On the
    CPU nothing changes.  Neither branch needs a card."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with deterministic(torch.device("cpu")):
        assert not torch.are_deterministic_algorithms_enabled()
    with deterministic(torch.device("cuda")):
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":4096:8"
        with pytest.raises(RuntimeError, match="deterministic"):
            torch.zeros(4).put_(torch.tensor([0, 0]), torch.ones(2))
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":16:8")
    with deterministic(torch.device("cuda")):
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
    assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == ":16:8"
