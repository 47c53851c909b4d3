from .ops import (BWD_DISPATCHES, DISPATCHES, DTYPE_LAUNCHES,
                  MambaScanFunction, mamba_scan, mamba_scan_bwd, mamba_step,
                  scan_work)
from .kernel import mamba_scan_bwd_cuda, mamba_scan_cuda
from .ref import mamba_scan_bwd_ref, mamba_scan_ref, mamba_step_ref

__all__ = ["BWD_DISPATCHES", "DISPATCHES", "DTYPE_LAUNCHES",
           "MambaScanFunction", "mamba_scan", "mamba_scan_bwd",
           "mamba_scan_bwd_cuda", "mamba_scan_bwd_ref", "mamba_scan_cuda",
           "mamba_scan_ref", "mamba_step", "mamba_step_ref", "scan_work"]
