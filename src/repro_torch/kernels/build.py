"""Build a CUDA source of the port into a shared library and load it.

Each kernel ships a ``csrc/*.cu`` file with a plain ``extern "C"``
launcher — no PyTorch headers — so ``nvcc`` builds it in seconds.  It is
compiled for Hopper (``sm_90a``) at first use, from the sources in the
package, into ``_build/`` beside this file (``REPRO_TORCH_BUILD_DIR``
overrides it), and loaded with :mod:`ctypes`.  The library's name carries a
hash of the source and the flags, so an edited kernel is rebuilt and an
unchanged one is reused; a kernel module keeps the loaded library for the
process.  Builds of different sources may run in parallel threads, and
racing builds of one source agree (the library is moved into place
atomically).  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "_build"


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use")


def load(source: Path) -> ctypes.CDLL:
    """Compile ``source`` unless its build exists; return the library."""
    source = Path(source)
    text = source.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"lib{source.stem}-{digest[:16]}.so"
    if not target.exists():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed building {source.name} "
                f"(rc={proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    return ctypes.CDLL(str(target))
