"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each source is compiled on its own by ``nvcc`` for Hopper (``sm_90a``) into
a library with a plain C interface, loaded with ``ctypes``. Nothing here
includes PyTorch's headers, so a build takes seconds. Libraries land in
``tedm_tpu_torch/_build/`` under a name that carries a hash of the source,
of every shared header ``csrc/*.cuh`` and of the flags, so an edited source
or header is rebuilt and an unchanged one is reused (``tedm_tpu_torch/_cc.py``,
shared with the host library's g++ build). The build runs at first use,
never at import.
"""

from __future__ import annotations

import ctypes
import os
import shutil

from tedm_tpu_torch import _cc

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> str:
    """Path of the built library for ``csrc/<name>.cu`` at its current
    content and that of every ``csrc/*.cuh`` it may include."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return _cc.library_path(BUILD_DIR, name, " ".join(NVCC_FLAGS),
                            [os.path.join(CSRC, part) for part in [name + ".cu"] + headers])


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists;
    return the library's path. Raises with nvcc's output on failure."""
    out = library_path(name)
    if not os.path.isfile(out):
        _cc.compile_into([find_nvcc(), *NVCC_FLAGS, os.path.join(CSRC, name + ".cu")], out, f"nvcc for {name}.cu")
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(build(name))
