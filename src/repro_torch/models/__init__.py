"""Model substrate: layers, attention, dense FFN, transformer assembly.

PyTorch port of :mod:`repro.models` for the serve path of the dense
architectures.  Not yet ported: the Mamba mixer, the MoE FFN, the
encoder, training (``loss_fn`` / ``train_step``) and ``sharding``.
"""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
