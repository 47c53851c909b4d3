"""The port's sharding rules (``repro_torch.models.sharding``, the dry
run's spec functions and ``opt_state_pspecs``) against the JAX package's,
spec for spec, on the production meshes' shapes.

Every architecture's *full* config: the JAX package's parameters, train
state and cache come from ``jax.eval_shape`` (its ``ShardingRules`` reads
only ``mesh.shape``, so a stub mesh serves), the port's from its ``meta``
init.  The JAX package stacks a scanned group's layers ``[n_groups,
...]``; the port keeps one dict a layer, so layer ``i`` of the groups is
held to group position ``i % group_len`` with the stacked dim's entry (a
None) dropped.  Specs compare entry by entry, as tuples.
"""
from types import SimpleNamespace

import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jax_shapes
from repro.launch import dryrun as jax_dryrun
from repro.launch import hillclimb as jax_hillclimb
from repro.models import build_model as jax_build_model
from repro.models import sharding as jax_sharding
from repro.train.optimizer import opt_state_pspecs as jax_opt_state_pspecs
from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs
from repro_torch.launch import dryrun, hillclimb
from repro_torch.models import build_model, sharding
from repro_torch.models.transformer import _plan, layer_kinds
from repro_torch.train.optimizer import opt_state_pspecs

MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


def meshes(kind):
    names, shape = MESHES[kind]
    return (SimpleNamespace(mesh_dim_names=names, shape=shape),
            SimpleNamespace(shape=dict(zip(names, shape))))


def _tuple(spec):
    return tuple(spec)


def _is_spec(s):
    return isinstance(s, (jax.sharding.PartitionSpec, sharding.P))


def _walk(tree, fn):
    """``tree`` (dicts and lists down to specs) with each spec ``fn(spec)``."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, fn) for v in tree]
    assert _is_spec(tree), type(tree)
    return fn(tree)


def unstack(cfg, tree):
    """A JAX parameter-structured spec tree in the port's layout: each
    layer's subtree, its stacked dim's spec entry dropped."""
    n_groups, _, g = _plan(cfg)
    out = {k: v for k, v in tree.items() if k not in ("groups", "tail")}
    layers = []
    for i in range(len(layer_kinds(cfg))):
        if i < n_groups * g:
            grp, j = divmod(i, g)
            layers.append(_walk(tree["groups"][j],
                                lambda s: _tuple(s)[1:]))
        else:
            layers.append(tree["tail"][i - n_groups * g])
    out["layers"] = layers
    return out


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{path}/{i}").items()}
    return {path: _tuple(tree)}


def assert_same_specs(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in got:
        # JAX's P() (no rule) has no entries; a leaf's spec is otherwise
        # one entry a dim on both sides
        assert got[k] == want[k], k


@pytest.fixture(scope="module")
def jax_shapes_of():
    cache = {}

    def get(arch):
        if arch not in cache:
            m = jax_build_model(jax_get_config(arch))
            cache[arch] = jax.eval_shape(
                lambda: m.init_train_state(jax.random.key(0)))
        return cache[arch]
    return get


@pytest.fixture(scope="module")
def port_state():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = build_model(get_config(arch), "meta").init_train_state(0)
        return cache[arch]
    return get


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_specs_equal_the_reference(arch, kind, jax_shapes_of,
                                                 port_state):
    cfg = get_config(arch)
    pm, jm = meshes(kind)
    rules, jrules = sharding.make_rules(pm), jax_sharding.make_rules(jm)
    jstate = jax_shapes_of(arch)
    state = port_state(arch)
    jp = jax_sharding.tree_pspecs(jstate.params, jrules)
    p = sharding.tree_pspecs(state.params, rules)
    assert_same_specs(p, unstack(cfg, jp))
    jo = jax_opt_state_pspecs(jstate.opt, jp)
    o = opt_state_pspecs(state.opt, p)
    assert _tuple(o["step"]) == _tuple(jo["step"])
    got, want = _flat(o["mu"]), _flat(unstack(cfg, jo["mu"]))
    leaf = lambda k: k.rsplit("/", 1)[0]  # noqa: E731
    assert {leaf(k) for k in got} == {leaf(k) for k in want}
    params = _flat(p)
    for k in got.keys() - want.keys():
        # the JAX package factors the v of a per-layer vector, which its
        # stacking makes an [n_groups, d] matrix; the port keeps one
        # vector a layer, and its v whole, with the parameter's spec
        assert k.endswith("/v") and len(params[leaf(k)]) == 1, k
        assert got[k] == params[leaf(k)], k
        assert {leaf(k) + "/v_row", leaf(k) + "/v_col"} <= want.keys(), k
    for k in got.keys() & want.keys():
        assert got[k] == want[k], k


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_batch_logits_specs_equal_the_reference(arch, kind):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    pm, jm = meshes(kind)
    model = build_model(cfg, "meta")
    jmodel = jax_build_model(jcfg)
    for name, s in SHAPES.items():
        ok, _ = jax_shapes.cell_applicable(jcfg, jax_shapes.SHAPES[name])
        if not ok:
            continue
        rules = dryrun.cell_rules(pm, name)
        jrules = jax_dryrun.cell_rules(jm, name)
        assert rules.rules == jrules.rules
        js = jax_shapes.SHAPES[name]
        assert _tuple(dryrun.logits_pspec(cfg, s, rules)) == \
            _tuple(jax_dryrun.logits_pspec(jcfg, js, jrules))
        got = dryrun.batch_pspecs(input_specs(cfg, s), rules)
        want = jax_dryrun.batch_pspecs(jax_shapes.input_specs(jcfg, js), jrules)
        assert {k: _tuple(v) for k, v in got.items()} == \
            {k: _tuple(v) for k, v in want.items()}
        if s.kind == "train":
            continue
        # a 1-row cache of the cell's length: the specs' guards see the
        # same dims (batch 1 replicates on both sides)
        cache = model.init_cache(s.global_batch, s.seq_len)
        jcache = jax.eval_shape(
            lambda: jmodel.init_cache(js.global_batch, js.seq_len))
        assert_same_specs(dryrun.cache_pspecs(cache, rules),
                          jax_dryrun.cache_pspecs(jcache, jrules))


@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cell_and_ep_rules_equal_the_reference(kind, shape):
    pm, jm = meshes(kind)
    assert dryrun.cell_rules(pm, shape).rules == \
        jax_dryrun.cell_rules(jm, shape).rules
    assert dryrun.ep_rules(shape)(pm).rules == \
        jax_dryrun.ep_rules(shape)(jm).rules


@pytest.mark.parametrize("kind", sorted(MESHES))
def test_make_rules_filters_axes_as_the_reference(kind):
    pm, jm = meshes(kind)
    over = dict(batch=("pod", "data"), seq=("data", "model"), kv_seq="pod",
                experts="model", vocab=("pod",))
    assert sharding.make_rules(pm, **over).rules == \
        jax_sharding.make_rules(jm, **over).rules
    assert sharding.DEFAULT_RULES == jax_sharding.DEFAULT_RULES
    assert sharding.PARAM_RULES == jax_sharding.PARAM_RULES


def test_constrain_is_a_noop_without_rules_and_checks_arity():
    x = torch.randn(2, 3, 4)
    assert sharding.constrain(x, "batch", "seq", "embed") is x
    pm, _ = meshes("single")
    with sharding.sharding_rules(sharding.make_rules(pm)):
        # a plain tensor under rules is left as it is
        assert sharding.constrain(x, "batch", "seq", "embed") is x
        with pytest.raises(ValueError, match="arity"):
            sharding.constrain(x, "batch", "seq")


@pytest.mark.parametrize("spec", [
    (None, None), ("data", None), (None, "model"), ("model", "data"),
    (("data", "model"), None), (("pod", "data"), "model"),
    ("pod", ("data", "model"))])
def test_placements_give_the_reference_shard_shapes(spec):
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec
    names, shape = MESHES["multi"]
    pm = SimpleNamespace(mesh_dim_names=names, shape=shape)
    global_shape = (512, 1024)
    want = NamedSharding(AbstractMesh(shape, names),
                         PartitionSpec(*spec)).shard_shape(global_shape)
    local = list(global_shape)
    for j, p in enumerate(sharding.placements(spec, pm)):
        if hasattr(p, "dim"):
            local[p.dim] //= shape[j]
    assert tuple(local) == tuple(want)


@pytest.mark.parametrize("variant", ["ep", "mb4", "noremat", "kvint8",
                                     "nosp", "mb2nosp", "seqdata", "kvboth"])
def test_hillclimb_variants_equal_the_reference(variant):
    arch, shape = "granite-moe-1b-a400m", "train_4k"
    cfg, rules = hillclimb.variant_spec(variant, arch, shape)
    jcfg, jrules = jax_hillclimb.variant_spec(variant, arch, shape)
    assert (cfg is None) == (jcfg is None)
    if cfg is not None:
        assert vars(cfg) == vars(jcfg)
    assert (rules is None) == (jrules is None)
    if rules is not None:
        for kind in MESHES:
            pm, jm = meshes(kind)
            assert rules(pm).rules == jrules(jm).rules
