"""BS006 fixture: the plain version and host stacks leaking into a launcher."""
import ctypes

import torch
import numpy as np                           # BS006: numpy belongs in ref.py
import jax                                   # BS006: no jax in the port

from .ref import demo_ref                    # BS006: the plain version
from .ops import dispatch                    # BS006: the dispatch
from . import ref                            # BS006: the plain version
from ..other import ops as other_ops         # BS006: another kernel's ops
from ..build import load


def launch(x):
    del ctypes, torch, np, jax, demo_ref, dispatch, ref, other_ops, load
    return x
