"""Model substrate: layers, attention, Mamba, dense FFN, transformer assembly.

PyTorch port of :mod:`repro.models`: the serve path of the dense and SSM
architectures, and training (``loss_fn`` / ``grad_step`` / ``train_step``)
of the dense family.  Not yet ported: the hybrid (Mamba beside attention),
the MoE FFN, the encoder, Mamba's ``train`` mode and ``sharding``.
"""
from .model import Model, TrainState, build_model

__all__ = ["Model", "TrainState", "build_model"]
