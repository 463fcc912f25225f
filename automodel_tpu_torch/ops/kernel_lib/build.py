"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``automodel_tpu_torch/_build/`` (listed in ``.gitignore``).  The library's
file name carries a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as built.  :func:`build_many` runs one ``nvcc``
per source, all at once.  A failed build raises with nvcc's stderr;
nothing falls back to another implementation.

Nothing here runs at import time: the CPU test suite imports every module
of the port on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built from source at first use")
    return nvcc


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to under the current source, shared
    headers and flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build_many(names: List[str]) -> List[str]:
    """Compile every ``csrc/<name>.cu`` whose current build is missing, one
    ``nvcc`` process per source, all started together; returns the library
    paths in order.  Raises ``RuntimeError`` with nvcc's stderr of every
    failed source."""
    outs = [library_path(n) for n in names]
    jobs = []
    for name, out in zip(names, outs):
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, cmd, tmp, out, proc))
    errors = []
    for name, cmd, tmp, out, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed to build {name}.cu (exit "
                          f"{proc.returncode}):\n{' '.join(cmd)}\n{err}")
        else:
            os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its current build exists; returns
    the library path.  Raises ``RuntimeError`` with nvcc's stderr."""
    return build_many([name])[0]


def ptr(t):
    """A kernel's pointer argument for an optional tensor: its address, or
    None (a null pointer through ctypes)."""
    return None if t is None else t.data_ptr()


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first call in
    this process)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
