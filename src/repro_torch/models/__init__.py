"""Model substrate: layers, attention, Mamba, dense and MoE FFNs, transformer
assembly.

PyTorch port of :mod:`repro.models`: the serve path and training
(``loss_fn`` / ``grad_step`` / ``train_step``) of the dense, MoE, SSM and
hybrid (Mamba beside attention) architectures.  Not yet ported: the
encoder and ``sharding``.
"""
from .model import Model, TrainState, build_model

__all__ = ["Model", "TrainState", "build_model"]
