"""The port's MoE FFN on a card: against the plain CPU run, repeatable bit
for bit under the trainer's deterministic algorithms, and remat selecting
the experts the forward selected.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither ``jax`` nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_moe.py

Tolerances are those of the model parity on the card: fp32 products in
full fp32 (TF32 off), 1e-4 against the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import build_model, mlp
from repro_torch.runtime.ft import deterministic
from repro_torch.tree import leaves, map_tree

ARCH = "granite-moe-1b-a400m"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tokens(cfg, B=2, T=33, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, T)), dtype=torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", [ARCH, "grok-1-314b"])
@pytest.mark.parametrize("T", [1, 40, 300])
def test_moe_ffn_on_the_card_matches_the_cpu(cuda, arch, T):
    cfg = smoke_config(arch).replace(capacity_factor=0.5)
    gen = torch.Generator().manual_seed(T)
    p = mlp.init_moe_ffn(gen, cfg, torch.float32)
    x = torch.randn((2, T, cfg.d_model), generator=gen)
    want_y, want_aux = mlp.moe_ffn(p, cfg, x)
    want_r = mlp.route(p, cfg, x, mlp.capacity(cfg, T))
    gp = map_tree(lambda t: t.to(cuda), p)
    y, aux = mlp.moe_ffn(gp, cfg, x.to(cuda))
    r = mlp.route(gp, cfg, x.to(cuda), mlp.capacity(cfg, T))
    for name in ("sel", "keep", "dest", "src"):
        assert torch.equal(getattr(r, name).cpu(), getattr(want_r, name)), name
    torch.testing.assert_close(y.cpu(), want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_moe_grad_steps_repeat_bit_for_bit_under_deterministic(cuda):
    """Every op of the dispatch (stable sort, searchsorted, the scatters,
    the permutation's gathers both ways) runs under enforced deterministic
    algorithms without raising, and two gradient steps agree bit for bit."""
    cfg = smoke_config(ARCH)
    model = build_model(cfg, cuda)
    params = model.init(0)
    tok = _tokens(cfg).to(cuda)
    out = []
    for _ in range(2):
        with deterministic(cuda):
            out.append(model.grad_step(params, {"tokens": tok}))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(leaves(out[0][1]), leaves(out[1][1])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_remat_on_the_card_recomputes_the_same_experts(cuda, monkeypatch):
    cfg = smoke_config(ARCH).replace(remat=True)
    model = build_model(cfg, cuda)
    params = model.init(0)
    seen = []
    route = mlp.route

    def recording(*args):
        r = route(*args)
        seen.append(r.sel.clone())
        return r

    monkeypatch.setattr(mlp, "route", recording)
    fa.DISPATCHES.reset()
    loss, _ = model.grad_step(params, {"tokens": _tokens(cfg).to(cuda)})
    assert torch.isfinite(loss)
    assert fa.DISPATCHES.kernel_launches == 2 * cfg.n_layers
    L = cfg.n_layers
    assert len(seen) == 2 * L
    for i in range(L):
        assert torch.equal(seen[i], seen[2 * L - 1 - i]), i


@pytest.mark.gpu
def test_moe_train_step_on_the_card_matches_the_cpu(cuda):
    cfg = smoke_config(ARCH)
    cpu, gpu = build_model(cfg, "cpu"), build_model(cfg, cuda)
    state = cpu.init_train_state(0)
    gstate = map_tree(lambda t: t.to(cuda), state)
    tok = _tokens(cfg, B=4)
    state, m_cpu = cpu.train_step(state, {"tokens": tok})
    gstate, m_gpu = gpu.train_step(gstate, {"tokens": tok.to(cuda)})
    assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]),
                                                 abs=1e-4)
    for a, b in zip(leaves(gstate.params), leaves(state.params)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)
