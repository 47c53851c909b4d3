"""Model substrate: layers, attention, Mamba, dense and MoE FFNs, transformer
assembly.

PyTorch port of :mod:`repro.models`: the serve path of the dense, MoE and
SSM architectures, and training (``loss_fn`` / ``grad_step`` /
``train_step``) of the dense and MoE families.  Not yet ported: the hybrid
(Mamba beside attention), the encoder, Mamba's ``train`` mode and
``sharding``.
"""
from .model import Model, TrainState, build_model

__all__ = ["Model", "TrainState", "build_model"]
