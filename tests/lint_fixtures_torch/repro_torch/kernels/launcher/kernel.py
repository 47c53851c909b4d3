"""BS006 fixture: every import the port's launchers make is allowed."""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from ..build import load
from ..flash_attention.kernel import DTYPE_CODES


def launch(x) -> Tuple:
    del collections, ctypes, functools, math, Path, NamedTuple, Optional
    del torch, load, DTYPE_CODES
    return (x,)
