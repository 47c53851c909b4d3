from .ops import DISPATCHES, DTYPE_LAUNCHES, mamba_scan, mamba_step
from .kernel import mamba_scan_cuda
from .ref import mamba_scan_ref, mamba_step_ref

__all__ = ["DISPATCHES", "DTYPE_LAUNCHES", "mamba_scan", "mamba_scan_cuda", "mamba_scan_ref",
           "mamba_step", "mamba_step_ref"]
