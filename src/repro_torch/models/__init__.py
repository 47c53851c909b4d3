"""Model substrate: layers, attention, Mamba, dense and MoE FFNs, transformer
assembly.

PyTorch port of :mod:`repro.models`: the serve path and training
(``loss_fn`` / ``grad_step`` / ``train_step``) of the dense, MoE, SSM,
hybrid (Mamba beside attention) and encoder-decoder architectures, and
``sharding``: the logical-axis rules that place them on a DeviceMesh.
"""
from .model import Model, TrainState, build_model

__all__ = ["Model", "TrainState", "build_model"]
