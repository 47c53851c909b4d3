"""Model configurations: the schema, the ten architectures, the registry.

PyTorch port of :mod:`repro.configs`, without ``shapes`` (the dry run's
``jax.ShapeDtypeStruct`` input specs, which the port has not yet).
"""
from .base import ModelConfig
from .registry import ARCHS, get_config, smoke_config

__all__ = ["ModelConfig", "ARCHS", "get_config", "smoke_config"]
