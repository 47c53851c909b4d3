"""Model configurations: the schema, the ten architectures, the registry,
and the dry run's shape cells.

PyTorch port of :mod:`repro.configs` (``shapes`` gives meta tensors where
the JAX package gives ``jax.ShapeDtypeStruct``\\ s).
"""
from .base import ModelConfig
from .registry import ARCHS, get_config, smoke_config
from .shapes import SHAPES, input_specs, shape_cells

__all__ = ["ModelConfig", "ARCHS", "get_config", "smoke_config", "SHAPES",
           "input_specs", "shape_cells"]
