"""The port's MoE FFN and the MoE architectures against the JAX package's,
on the CPU.

The same inputs, made from numpy seeds, go through both packages in fp32:
``moe_ffn``'s output and load-balance loss at a capacity that drops
token-slots and at dropless capacity, at B = 1 and 2, at the smoke widths
of ``granite-moe-1b-a400m`` (SwiGLU) and ``grok-1-314b`` (GeGLU); the row
permutation of the dispatch and its VJP (both gathers: bit for bit);
``moe_ffn``'s gradients against ``jax.grad``; and the smoke models whole,
with the JAX parameters carried across by ``params_from_jax``: prefill
logits and caches, decode steps, the engines' greedy streams, two
``train_step``s (grok's factored moments over 3-D expert leaves) and the
fault-tolerant trainer through a crash.  Tolerances are those of
``tests/test_torch_model.py`` and ``tests/test_torch_train.py``: fp32 sums
taken in other orders by XLA:CPU and PyTorch.

Capacity dropping depends on the shape (``tests/test_archs.py``): prefill
is compared with prefill and decode with decode, and decode against a
teacher-forced forward only at dropless capacity (``E / K``).  Seeded fp32
router inputs have no ties, so ``jax.lax.top_k`` and ``torch.topk`` pick
the same experts; the order within a token would not change any rank, as
a token takes each expert at most once.
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from numpy.testing import assert_allclose

from repro.configs import smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.models import mlp as jax_mlp
from repro.models.model import _logits as jax_logits
from repro.models.transformer import forward as jax_forward
from repro.runtime.ft import FTConfig as JaxFTConfig
from repro.runtime.ft import FTTrainer as JaxFTTrainer
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch.configs import smoke_config
from repro_torch.interop import params_from_jax, train_state_from_jax
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import build_model, mlp
from repro_torch.models.transformer import forward, layer_cache
from repro_torch.runtime.ft import FTConfig, FTTrainer
from repro_torch.serve import ServeEngine
from repro_torch.tree import leaves
from torch_trees import (adam_step_at_rounding, assert_trees_close,
                         bf16_ulps_apart)

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
MOE_ARCHS = ["granite-moe-1b-a400m", "grok-1-314b"]
# capacity factors: E / K never drops a slot; 0.5 drops about half
CAPACITY = {"dropless": None, "drops": 0.5}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(smoke_config(arch), **kw)
    assert vars(jcfg) == vars(tcfg)
    return jcfg, tcfg


def _capacity_cfgs(arch, capacity):
    cf = CAPACITY[capacity]
    cfg = smoke_config(arch)
    if cf is None:
        cf = cfg.n_experts / cfg.experts_per_token
    return _cfgs(arch, capacity_factor=cf)


def _moe_inputs(jcfg, B, T, seed):
    jp = jax_mlp.init_moe_ffn(jax.random.key(seed), jcfg, jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp, x


def _dropped(tcfg, tp, x):
    r = mlp.route(tp, tcfg, torch.from_numpy(x),
                  mlp.capacity(tcfg, x.shape[1]))
    return int((~r.keep).sum())


# ------------------------------------------------------------ the FFN
@pytest.mark.parametrize("T", [1, 7, 40, 4096])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_jax(arch, T):
    jcfg, tcfg = _cfgs(arch)
    assert mlp.capacity(tcfg, T) == jax_mlp.capacity(jcfg, T)


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, B, capacity):
    jcfg, tcfg = _capacity_cfgs(arch, capacity)
    jp, tp, x = _moe_inputs(jcfg, B, 40, seed=B)
    jy, jaux = jax.jit(jax_mlp.moe_ffn, static_argnums=1)(jp, jcfg,
                                                          jnp.asarray(x))
    ty, taux = mlp.moe_ffn(tp, tcfg, torch.from_numpy(x))
    assert ty.shape == (B, 40, tcfg.d_model) and ty.dtype == torch.float32
    assert taux.dtype == torch.float32 and taux.dim() == 0
    assert_allclose(_np(ty), np.asarray(jy), **TOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    dropped = _dropped(tcfg, tp, x)
    assert (dropped > 0) == (capacity == "drops"), dropped


@pytest.mark.parametrize("capacity", list(CAPACITY))
def test_routing_src_inverts_dest(capacity):
    """``src`` is ``dest`` inverted with the dropped slots discarded: each
    kept token-slot fills the expert slot it was sent to, and every expert
    slot that no kept token-slot fills holds ``T*K``."""
    jcfg, tcfg = _capacity_cfgs("granite-moe-1b-a400m", capacity)
    _, tp, x = _moe_inputs(jcfg, 2, 40, seed=3)
    C = mlp.capacity(tcfg, 40)
    r = mlp.route(tp, tcfg, torch.from_numpy(x), C)
    E, TK = tcfg.n_experts, 40 * tcfg.experts_per_token
    for b in range(2):
        want = torch.full((E * C,), TK, dtype=torch.long)
        kept = r.keep[b].nonzero()[:, 0]
        want[r.dest[b, kept]] = kept
        assert torch.equal(r.src[b], want)
        assert torch.equal(r.dest[b, ~r.keep[b]],
                           torch.full_like(r.dest[b, ~r.keep[b]], E * C))


def test_router_stays_fp32_beside_bf16_experts():
    cfg = smoke_config("granite-moe-1b-a400m").replace(dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = mlp.init_moe_ffn(gen, cfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    assert {p[k].dtype for k in ("e_gate", "e_up", "e_down")} == \
        {torch.bfloat16}
    assert p["e_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert p["e_down"].shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    x = torch.randn((2, 9, cfg.d_model), generator=gen).to(torch.bfloat16)
    y, aux = mlp.moe_ffn(p, cfg, x)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())


def _permutation(rng, B, M, S, D):
    """Rows ``x [B, M, D]`` sent to ``S`` slots, some dropped: ``idx`` (for
    each slot its row, M if empty) and ``inv`` (for each row its slot, S
    if dropped), as the dispatch's ``src`` and ``dest``."""
    x = rng.standard_normal((B, M, D)).astype(np.float32)
    idx = np.full((B, S), M, np.int32)
    inv = np.full((B, M), S, np.int32)
    for b in range(B):
        slots = rng.permutation(S)[:M]
        for row, slot in enumerate(slots):
            if rng.random() < 0.75:
                idx[b, slot], inv[b, row] = row, slot
    return x, idx, inv


def test_permute_rows_and_its_vjp_match_jax_bit_for_bit():
    rng = np.random.default_rng(6)
    B, M, S, D = 2, 12, 16, 5
    x, idx, inv = _permutation(rng, B, M, S, D)
    ct = rng.standard_normal((B, S, D)).astype(np.float32)
    want, want_dx = [], []
    for b in range(B):
        out, vjp = jax.vjp(lambda r, b=b: jax_mlp._permute_rows(
            r, jnp.asarray(idx[b]), jnp.asarray(inv[b])), jnp.asarray(x[b]))
        want.append(np.asarray(out))
        want_dx.append(np.asarray(vjp(jnp.asarray(ct[b]))[0]))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = mlp.PermuteRows.apply(tx, torch.from_numpy(idx).long(),
                                torch.from_numpy(inv).long())
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(ct))
    assert np.array_equal(_np(out), np.stack(want))
    assert np.array_equal(_np(dx), np.stack(want_dx))
    assert np.array_equal(_np(out)[idx == M], np.zeros(((idx == M).sum(), D)))


@pytest.mark.parametrize("capacity", list(CAPACITY))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_gradients_match_jax_grad(arch, capacity):
    jcfg, tcfg = _capacity_cfgs(arch, capacity)
    jp, tp, x = _moe_inputs(jcfg, 2, 24, seed=11)
    w = np.random.default_rng(12).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_mlp.moe_ffn(p, jcfg, xx)
        return jnp.sum(y * w) + 0.37 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = mlp.moe_ffn(live, tcfg, tx)
    loss = (y * torch.from_numpy(w)).sum() + 0.37 * aux
    names = ["router", "e_gate", "e_up", "e_down"]
    grads = torch.autograd.grad(loss, [tx] + [live[n] for n in names])
    assert_allclose(_np(grads[0]), np.asarray(jgx), err_msg="x", **GRAD_TOL)
    for name, g in zip(names, grads[1:]):
        assert_allclose(_np(g), np.asarray(jgp[name]), err_msg=name,
                        **GRAD_TOL)


# ------------------------------------------------------- the model served
def _models(arch, seed=0, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(seed))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jmodel, jparams, build_model(tcfg, "cpu"), tparams


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_from_jax_keep_the_experts_and_an_fp32_router(arch):
    jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    for i, layer in enumerate(tparams["layers"]):
        ffn = layer["ffn"]
        assert ffn["router"].dtype == torch.float32
        assert ffn["e_gate"].dtype == torch.bfloat16
        assert ffn["e_up"].shape == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
        for name, leaf in ffn.items():
            want = np.asarray(jparams["groups"][0]["ffn"][name][i], np.float32)
            assert np.array_equal(_np(leaf), want), (i, name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jmodel, jparams, tmodel, tparams = _models(arch)
    rng = np.random.default_rng(3)
    B, T, max_len = 2, 12, 40
    prompt = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    lj, cj = jmodel.prefill_step(jparams, {"tokens": jnp.asarray(prompt)},
                                 max_len=max_len)
    lt, ct = tmodel.prefill_step(tparams, {"tokens": torch.from_numpy(prompt)},
                                 max_len=max_len)
    assert lt.shape == (B, tcfg.vocab_size)
    assert_allclose(_np(lt), np.asarray(lj), **TOL)
    lens = np.array([T, 9], np.int32)
    decode = jax.jit(jmodel.decode_step)
    for _ in range(3):
        tok = rng.integers(0, tcfg.vocab_size, (B, 1)).astype(np.int32)
        lj, cj = decode(jparams, cj, jnp.asarray(tok), jnp.asarray(lens))
        lt, ct = tmodel.decode_step(tparams, ct, torch.from_numpy(tok),
                                    torch.from_numpy(lens))
        assert_allclose(_np(lt), np.asarray(lj), **TOL)
        lens = lens + 1
    checked = 0
    for i in range(tcfg.n_layers):
        lj_ = layer_cache(jax.tree.map(lambda a: torch.tensor(
            np.asarray(a, np.float32)), cj), tcfg, i)
        lt_ = layer_cache(ct, tcfg, i)
        for b, n in enumerate(lens):
            for name in ("k", "v"):
                a, g = _np(lj_[name][b, :, :n]), _np(lt_[name][b, :, :n])
                if f"{name}_scale" in lt_:
                    # int8 (grok): at most one quantisation step apart
                    assert np.abs(a - g).max() <= 1, (i, name)
                    assert np.mean(a != g) < 0.01, (i, name)
                else:
                    assert_allclose(g, a, err_msg=f"layer {i} {name}", **TOL)
                checked += 1
    assert checked == tcfg.n_layers * B * 2
    assert ("k_scale" in lt_) == (tcfg.kv_cache_dtype == "int8")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_token_streams_match_jax(arch):
    # the tied embedding shrunk 20x, as in tests/test_torch_engine.py: at
    # random init a token's own embedding dominates its logits and greedy
    # decoding repeats the prompt's last token whatever the layers do
    jcfg, tcfg = _cfgs(arch)
    jparams = dict(jax_build_model(jcfg).init(jax.random.key(0)))
    jparams["embed"] = {"tok": jparams["embed"]["tok"] * 0.05}
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size, n) for n in (5, 21) * 3]
    jeng = JaxServeEngine(jcfg, jparams, max_batch=4, max_len=64)
    jreqs = [jeng.submit(p, max_new_tokens=12) for p in prompts]
    jeng.run_until_drained()
    teng = ServeEngine(tcfg, tparams, max_batch=4, max_len=64, device="cpu")
    treqs = [teng.submit(p, max_new_tokens=12) for p in prompts]
    teng.run_until_drained()
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]
    assert all(r.done and len(r.out_tokens) == 12 for r in treqs)
    assert sum(len(set(r.out_tokens)) > 1 for r in treqs) >= 3


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_teacher_forced_forward_at_dropless_capacity(arch):
    cfg = smoke_config(arch)
    cf = cfg.n_experts / cfg.experts_per_token
    jcfg, tcfg, _, jparams, tmodel, tparams = _models(
        arch, seed=2, capacity_factor=cf, kv_cache_dtype="bfloat16")
    B, T = 1, 12
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (B, T)).astype(np.int32)
    hid, _, _ = jax_forward(jparams, jcfg, jnp.asarray(tokens), mode="train",
                            _return_hidden=True)
    want = np.asarray(jax_logits(jparams, jcfg, hid[:, -1:, :])[:, 0])
    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        thid, _, aux = forward(tparams, tcfg, tok, mode="train",
                               return_hidden=True)
        forced = tmodel.prefill_step(tparams, {"tokens": tok})[0]
    assert float(aux) > 0
    assert_allclose(_np(forced), want, **TOL)
    _, cache = tmodel.prefill_step(tparams, {"tokens": tok[:, :T - 1]})
    got, _ = tmodel.decode_step(tparams, cache, tok[:, T - 1:],
                                torch.full((B,), T - 1, dtype=torch.int32))
    assert_allclose(_np(got), _np(forced), **TOL)
    assert_allclose(_np(got), want, **TOL)


# ------------------------------------------------------ the model trained
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.key(0))
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  "cpu")
    tok = np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (4, 33)).astype(np.int32)
    jl, jg = jmodel.grad_step(jstate.params, {"tokens": jnp.asarray(tok)})
    tl, tg = build_model(tcfg, "cpu").grad_step(
        tstate.params, {"tokens": torch.from_numpy(tok)})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    want = params_from_jax(tcfg, jax.tree.map(np.asarray, jg), "cpu")
    assert_trees_close(tg, want, **GRAD_TOL)
    # the router learns from the CE and from the aux term
    assert all(float(layer["ffn"]["router"].abs().sum()) > 0
               for layer in tg["layers"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_two_train_steps_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jmodel = jax_build_model(jcfg)
    jstate = jmodel.init_train_state(jax.random.key(1))
    tmodel = build_model(tcfg, "cpu")
    tstate = train_state_from_jax(tcfg, jax.tree.map(np.asarray, jstate),
                                  "cpu")
    if tcfg.optimizer_moments == "factored":
        ffn = tstate.opt["mu"]["layers"][0]["ffn"]
        assert ffn["e_gate"]["v_row"].shape == (tcfg.n_experts, tcfg.d_model)
        assert ffn["e_gate"]["v_col"].shape == (tcfg.n_experts, tcfg.d_ff)
    toks = [np.random.default_rng(10 + step).integers(
        0, tcfg.vocab_size, (4, 33)).astype(np.int32) for step in range(2)]
    # the first step's gradients: where an entry's is at rounding level on
    # both sides, the two AdamW steps may differ (adam_step_at_rounding)
    _, jg = jmodel.grad_step(jstate.params, {"tokens": jnp.asarray(toks[0])})
    _, tg = tmodel.grad_step(tstate.params,
                             {"tokens": torch.from_numpy(toks[0])})
    first_step = adam_step_at_rounding(
        tg, params_from_jax(tcfg, jax.tree.map(np.asarray, jg), "cpu"),
        tmodel.opt_cfg.lr, grad_atol=GRAD_TOL["atol"])
    jstep = jax.jit(jmodel.train_step)
    for tok in toks:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tok)})
        tstate, tm = tmodel.train_step(tstate,
                                       {"tokens": torch.from_numpy(tok)})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    # the bf16 first moments: two roundings apart at most (bf16_ulps_apart)
    for got_tree, want_tree, atol, excuse in (
            (tstate.params, jstate.params, 1e-5, first_step),
            (tstate.opt["mu"], jstate.opt["mu"], 1e-6, bf16_ulps_apart(2))):
        want = params_from_jax(tcfg, jax.tree.map(np.asarray, want_tree),
                               "cpu")
        assert_trees_close(got_tree, want, rtol=1e-4, atol=atol,
                           excuse=excuse)


def test_remat_recomputes_the_same_routing(monkeypatch):
    """``cfg.remat`` reruns each layer in the backward, the router too: the
    recomputation must select the experts the forward selected (or the
    gradient would be another function's), and give the same loss and
    gradients as a run without remat."""
    cfg = smoke_config("granite-moe-1b-a400m")
    params = build_model(cfg, "cpu").init(0)
    tok = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 33)).astype(np.int32))
    seen = []
    route = mlp.route

    def recording(*args):
        r = route(*args)
        seen.append(r.sel.clone())
        return r

    monkeypatch.setattr(mlp, "route", recording)
    out = {}
    for remat in (False, True):
        seen.clear()
        out[remat] = build_model(cfg.replace(remat=remat), "cpu").grad_step(
            params, {"tokens": tok})
    # the forward's layers in order, then their recomputation in reverse
    L = cfg.n_layers
    assert len(seen) == 2 * L
    for i in range(L):
        assert torch.equal(seen[i], seen[2 * L - 1 - i]), i
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(leaves(out[True][1]), leaves(out[False][1])):
        assert torch.allclose(a, b, rtol=1e-6, atol=1e-7)


def test_trainer_losses_match_jax_through_a_crash():
    arch = "granite-moe-1b-a400m"
    kw = dict(n_hosts=3, global_batch=6, seq_len=16, ckpt_every=2)
    jcfg, tcfg = _cfgs(arch)
    jtr = JaxFTTrainer(jcfg, JaxFTConfig(**kw))
    tr = FTTrainer(tcfg, FTConfig(**kw), device="cpu")
    tr.state = train_state_from_jax(tcfg, jax.tree.map(np.asarray,
                                                       jtr.state), "cpu")
    got, want = [], []
    for t, out in ((tr, got), (jtr, want)):
        out += t.train_steps(2)
        t.crash_host(2)
        assert t.restore() == 2
        out += t.train_steps(2)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_launchers_serve_and_train_the_moe_smoke_config_on_cpu(capsys):
    arch = "granite-moe-1b-a400m"
    reqs = serve_launcher.main(["--arch", arch, "--preset", "smoke",
                                "--device", "cpu", "--requests", "3",
                                "--max-new", "4"])
    assert [len(r.out_tokens) for r in reqs] == [4, 4, 4]
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
    losses = train_launcher.main(["--arch", arch, "--preset", "smoke",
                                  "--device", "cpu", "--steps", "5",
                                  "--crash-at", "3", "--seq-len", "16"])
    out = capsys.readouterr().out
    assert "device=cpu" in out and "restored at step 3" in out
    assert len(losses) == 2 and all(np.isfinite(losses))
