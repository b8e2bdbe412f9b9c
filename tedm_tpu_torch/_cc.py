"""Cached, race-safe builds of the port's shared libraries.

Both builders use it: ``kernels/_build.py`` (nvcc, the CUDA kernels) and
``native/`` (g++, the host image path). A library's name carries a hash of
its flags and of every file it is built from, so an edited file is rebuilt
and an unchanged one is reused. A build writes a temp file beside its
target and renames it, so processes that build at once each load a whole
library. Imports neither torch nor JAX.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import subprocess
import tempfile
from typing import Sequence


def library_path(build_dir: str, stem: str, key: str, files: Sequence[str]) -> str:
    """``<build_dir>/<stem>-<hash>.so``, the hash of ``key`` (the flags) and
    of each file's name and content."""
    h = hashlib.sha256(key.encode())
    for path in files:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(build_dir, f"{stem}-{h.hexdigest()[:16]}.so")


def compile_into(cmd: Sequence[str], out: str, what: str) -> None:
    """Run ``cmd -o <temp file>`` and rename the temp file to ``out``.
    Raises ``RuntimeError`` with the compiler's output where it fails, and
    ``OSError`` where the compiler is missing; leaves no temp file."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    except OSError:
        os.unlink(tmp)
        raise
    if proc.returncode != 0:
        with contextlib.suppress(FileNotFoundError):  # a failed link removes its output itself
            os.unlink(tmp)
        raise RuntimeError(f"{what} failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
