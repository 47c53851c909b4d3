"""The calls of mamba_scan_bwd in the traced window against its roofline, from
the device trace (work counted by work/mamba_scan_bwd.py)."""
from portbench.metrics import roofline


def read(run):
    return roofline(run, "mamba_scan_bwd")
