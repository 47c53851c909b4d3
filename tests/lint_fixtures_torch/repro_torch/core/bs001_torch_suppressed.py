"""BS001 fixture: a justified escape in the port's directive silences it."""
import torch


def noise():
    return torch.randn(3)  # bigset-lint-torch: disable=BS001 -- fixture: a deliberate escape
