"""The port's shape cells (``repro_torch.configs.shapes``) against the JAX
package's: the same four cells, the same applicability for every
architecture, and meta-tensor input specs with the keys, shapes and types
of the JAX package's ``jax.ShapeDtypeStruct``\\ s."""
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jax_shapes
from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs, shape_cells
from repro_torch.configs import shapes

DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32}


def test_shapes_equal_the_reference():
    assert list(SHAPES) == list(jax_shapes.SHAPES)
    for name, s in SHAPES.items():
        want = jax_shapes.SHAPES[name]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == (
            want.name, want.seq_len, want.global_batch, want.kind)
    assert shapes.LONG_OK_FAMILIES == jax_shapes.LONG_OK_FAMILIES


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cell_applicable_matches(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in SHAPES:
        assert shapes.cell_applicable(cfg, SHAPES[name]) == \
            jax_shapes.cell_applicable(jcfg, jax_shapes.SHAPES[name])
    assert shapes.long_context_capable(cfg) == \
        jax_shapes.long_context_capable(jcfg)
    assert [s.name for s in shape_cells(cfg)] == \
        [s.name for s in jax_shapes.shape_cells(jcfg)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for s in shape_cells(cfg):
        got = input_specs(cfg, s)
        want = jax_shapes.input_specs(jcfg, jax_shapes.SHAPES[s.name])
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (arch, s.name, k)
            assert t.dtype == DTYPES[want[k].dtype.type], (arch, s.name, k)
