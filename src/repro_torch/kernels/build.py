"""Build a CUDA source of the port into a shared library and load it.

Each kernel ships a ``csrc/*.cu`` file with a plain ``extern "C"``
launcher — no PyTorch headers — so ``nvcc`` builds it in seconds.  It is
compiled for Hopper (``sm_90a``) at first use, from the sources in the
package, into ``_build/`` beside this file (``REPRO_TORCH_BUILD_DIR``
overrides it), and loaded with :mod:`ctypes`.  The library's name carries a
hash of the source, of every local header it includes (``#include "..."``,
found beside the file that names it) and of the flags, so an edited kernel
or header is rebuilt and an unchanged one is reused; a kernel module keeps the loaded library for the
process.  Builds of different sources may run in parallel threads, and
racing builds of one source agree (the library is moved into place
atomically).  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def source_text(source: Path) -> bytes:
    """``source``'s bytes, then those of each local header it includes,
    depth first, each header once."""
    out, seen, todo = [], set(), [Path(source).resolve()]
    while todo:
        path = todo.pop().resolve()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        out.append(text)
        todo.extend(reversed([path.parent / name.decode()
                              for name in _LOCAL_INCLUDE.findall(text)]))
    return b"".join(out)


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


def library_path(source: Path) -> Path:
    """Where ``source``'s library is built: its name carries a hash of
    :func:`source_text` and the flags."""
    source = Path(source)
    text = source_text(source) + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()
    return build_dir() / f"lib{source.stem}-{digest[:16]}.so"


def load(source: Path) -> ctypes.CDLL:
    """Compile ``source`` unless its build exists; return the library."""
    source = Path(source)
    target = library_path(source)
    out_dir = target.parent
    out_dir.mkdir(parents=True, exist_ok=True)
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
