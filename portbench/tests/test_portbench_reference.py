"""The frozen references against the program's plain (CPU) path at a
tiny width, in fp32: a layer of each kind, the served logits, and the
training reference's loss, gradients and AdamW steps."""
import pytest
import torch

from portbench import reference
from portbench.reference.common import scan_sequential, selective_scan
from portbench.spec import port_config
from portbench.traffic import train_batch
from portbench.weights import (layer_block, leaf_names, make_block,
                               make_params)

from conftest import tiny_spec

SEED = 2 ** 31 + 977


def _program_layer(spec, w, x):
    from repro_torch.models.transformer import apply_layer
    cfg = port_config(spec)
    mixer, ffn = cfg.layer_kind(0)
    pos = torch.arange(x.shape[1])[None].expand(x.shape[:2])
    out, _, _ = apply_layer(w, cfg, x, mixer, ffn, positions=pos,
                            mode="train", cache=None, cache_len=None)
    return out


@pytest.mark.parametrize("kind", ["decoder", "mamba1"])
def test_layer_matches_the_program(kind, cpu):
    spec = tiny_spec(kind, "float32")
    mod = reference.kind_module(spec)
    w = reference.layer_weights(spec, SEED, 0, cpu)
    x = torch.randn((2, 37, spec.d_model), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = mod.layer(w, x, spec)
        prog = _program_layer(spec, w, x)
    assert torch.allclose(ref, prog, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("T,chunk", [(1, 4), (13, 4), (64, 16), (70, 8)])
def test_chunked_scan_is_the_recurrence(T, chunk):
    g = torch.Generator().manual_seed(T)
    B, D, N = 2, 12, 4
    u = torch.randn((B, T, D), generator=g)
    delta = torch.rand((B, T, D), generator=g) * 2
    A = -torch.rand((D, N), generator=g) * 8
    Bm, Cm = torch.randn((B, T, N), generator=g), torch.randn((B, T, N), generator=g)
    Dp = torch.randn(D, generator=g)
    from portbench.reference import common
    want = scan_sequential(u, delta, A, Bm, Cm, Dp)
    got = common.scan_block(u, delta, A, Bm, Cm, chunk=chunk) + u * Dp
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    got2 = selective_scan(u, delta, A, Bm, Cm, Dp, channels=5)
    assert torch.allclose(got2, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["decoder", "mamba1"])
def test_served_logits_match_the_program(kind, cpu):
    from repro_torch.models.transformer import forward
    spec = tiny_spec(kind, "float32")
    cfg = port_config(spec)
    params = make_params(spec, SEED, cpu)
    toks = torch.randint(0, spec.vocab, (29,),
                         generator=torch.Generator().manual_seed(3))
    want_pos = torch.arange(20, 29)
    with torch.no_grad():
        prog = forward(params, cfg, toks[None], mode="train")[0][0, want_pos]
    ref = reference.served_logits(spec, SEED, cpu, [toks], [want_pos])[0]
    assert torch.allclose(ref, prog, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind", ["decoder", "mamba1"])
def test_training_reference_matches_the_program(kind, cpu):
    from repro_torch.models import build_model
    from repro_torch.models.model import TrainState
    from repro_torch.train.optimizer import init_opt_state
    from portbench.train import (change_norms, compare, first_grad_norms,
                                 optimizer)
    from conftest import tiny_cell
    cell = tiny_cell(kind, "train", dtype="float32")
    spec, t = cell.spec, cell.traffic
    model = build_model(port_config(spec), cpu, optimizer(t))
    params = make_params(spec, SEED, cpu)
    state = TrainState(params, init_opt_state(params, model.opt_cfg),
                       torch.zeros((), dtype=torch.int32))
    batches = [train_batch(t, spec.vocab, SEED, k, cpu) for k in range(2)]
    losses = []
    for k, b in enumerate(batches):
        state, met = model.train_step(state, {"tokens": b})
        losses.append(float(met["loss"]))
        if k == 0:
            first = first_grad_norms(state, spec, t["optimizer"]["b1"])
    prog = {"losses": losses, "first_grad": first,
            "change": change_norms(state.params, spec, SEED, cpu)}
    ref = reference.train_reference(spec, SEED, cpu, batches, t["optimizer"])
    gaps = compare(prog, ref)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["first_grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3
    assert len(list(leaf_names(spec))) == sum(len(b) for b in ref["change"].values())
