"""BS001 fixture: ``models/`` is not a deterministic layer."""
import torch


def init(shape):
    torch.manual_seed(0)
    return torch.randn(shape)
