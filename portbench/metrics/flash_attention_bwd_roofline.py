"""The calls of flash_attention_bwd in the traced window against its roofline, from
the device trace (work counted by work/flash_attention_bwd.py)."""
from portbench.metrics import roofline


def read(run):
    return roofline(run, "flash_attention_bwd")
