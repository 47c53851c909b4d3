"""The calls of flash_attention in the traced window against its roofline, from
the device trace (work counted by work/flash_attention.py)."""
from portbench.metrics import roofline


def read(run):
    return roofline(run, "flash_attention")
