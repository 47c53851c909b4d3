"""Where the port's entry points run: on the card unless told otherwise."""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`, ``"cuda"`` when None.

    Raises when a CUDA device is asked for and there is none: an entry
    point never carries on on the CPU unless its caller passed ``"cpu"``.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch: device {str(dev)!r} requested but no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return dev

