"""Model substrate: layers, attention, Mamba, dense FFN, transformer assembly.

PyTorch port of :mod:`repro.models` for the serve path of the dense and
SSM architectures.  Not yet ported: the hybrid (Mamba beside attention),
the MoE FFN, the encoder, training (``loss_fn`` / ``train_step``) and
``sharding``.
"""
from .model import Model, build_model

__all__ = ["Model", "build_model"]
