"""The host image path in C++: PIL-exact resampling and PNG decoding (port of
``tedm_tpu/native/``).

``cc/resample.cpp`` is Pillow's fixed-point separable resampling of one
8-bit band (BICUBIC, PIL's resize default for mode 'L', BILINEAR and
NEAREST), with a ``std::thread`` fan-out over a batch. ``cc/imageio.cpp``
decodes a PNG with libpng into PIL's ``convert('L')`` bytes and resizes
them, one file or a whole batch across threads, without the GIL. Both are
copies of the JAX package's sources; this module binds them with ctypes and
imports numpy and nothing of torch or JAX.

The library is built at first use, never at import, by ``g++`` into
``tedm_tpu_torch/_build/``, under a name that carries a hash of both
sources, the flags and the flavor: ``png`` where g++ finds libpng's
headers, else ``resize`` (no PNG entry points). A resize-only library is so
replaced by a PNG one once the headers appear; where the PNG build fails
all the same (headers but no ``-lpng``), the resize-only one is built, and
``png_error()`` keeps g++'s output; so too where a PNG library does not
load (libpng missing at run time). A resize-only library already built is
loaded where there is no g++. The name and the temp-file-then-rename build
are ``tedm_tpu_torch/_cc.py``'s, shared with the CUDA kernels' build. A
failed build is kept with g++'s output (both flavors'): ``available()`` is
False, and ``resize_u8`` raises with that output.

``TEDM_NATIVE=0``, read at each call, makes ``available()`` and
``png_available()`` False, so the readers (``data/datasets.py``) decode and
resize with PIL, which gives the same bytes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from tedm_tpu_torch import _cc

CC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
SOURCES = ("resample.cpp", "imageio.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
# flavor -> (sources, link flags)
FLAVORS = {"png": (SOURCES, ("-lpng", "-lz")), "resize": (SOURCES[:1], ())}
FILTERS = {"nearest": 0, "bilinear": 1, "bicubic": 2}

_U8P = ctypes.POINTER(ctypes.c_uint8)


def _png_headers() -> bool:
    """Whether g++ finds libpng's ``png.h`` on its include path."""
    proc = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                          input="#include <png.h>\n", capture_output=True, text=True)
    return proc.returncode == 0


def library_path(flavor: str, build_dir: Optional[str] = None) -> str:
    """Path of the library of ``flavor`` at the sources' current content."""
    return _cc.library_path(build_dir or BUILD_DIR, f"tedm_native-{flavor}",
                            " ".join((*CXX_FLAGS, *FLAVORS[flavor][1], flavor)),
                            [os.path.join(CC, name) for name in SOURCES])


def _compile(flavor: str, out: str) -> None:
    sources, libs = FLAVORS[flavor]
    _cc.compile_into(["g++", *CXX_FLAGS, *(os.path.join(CC, s) for s in sources), *libs], out,
                     f"g++ for the {flavor} library")


def build(build_dir: Optional[str] = None) -> Tuple[str, str, Optional[str]]:
    """Compile the library unless one of the same hash exists; returns its
    path, its flavor, and g++'s output where the PNG build failed and the
    resize-only one stands in (else None). Raises ``RuntimeError`` with
    g++'s output where no flavor builds, and ``OSError`` where there is no
    g++ and no library."""
    png = library_path("png", build_dir)
    if os.path.isfile(png):
        return png, "png", None
    png_error = None
    if shutil.which("g++") is not None and _png_headers():
        try:
            _compile("png", png)
            return png, "png", None
        except RuntimeError as e:  # headers, but libpng or zlib does not link
            png_error = str(e)
    return _build_resize(build_dir, png_error)


def _build_resize(build_dir: Optional[str], png_error: Optional[str]) -> Tuple[str, str, Optional[str]]:
    """The resize-only library, reused where built; ``png_error`` says why
    the PNG one does not stand, and joins g++'s output where this fails."""
    resize = library_path("resize", build_dir)
    if not os.path.isfile(resize):
        if shutil.which("g++") is None:
            raise OSError("\n".join(filter(None, (png_error, "no g++ on PATH and no native library built"))))
        try:
            _compile("resize", resize)
        except RuntimeError as e:
            raise RuntimeError("\n".join(filter(None, (png_error, str(e))))) from None
    return resize, "resize", png_error


def _declare(lib: ctypes.CDLL, flavor: str) -> None:
    lib.tedm_resize_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tedm_resize_u8.restype = ctypes.c_int
    lib.tedm_resize_batch_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tedm_resize_batch_u8.restype = ctypes.c_int
    if flavor == "png":
        lib.tedm_png_decode_resize.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.tedm_png_decode_resize.restype = ctypes.c_int
        lib.tedm_png_decode_resize_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _U8P,
                                                     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                     ctypes.POINTER(ctypes.c_int)]
        lib.tedm_png_decode_resize_batch.restype = ctypes.c_int


class _Library:
    """The process's library, built and loaded once, or the reason it is not."""

    def __init__(self):
        self._lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.flavor: Optional[str] = None
        self.error: Optional[str] = None
        self.png_error: Optional[str] = None

    def get(self) -> Optional[ctypes.CDLL]:
        if self.lib is None and self.error is None:
            with self._lock:
                if self.lib is None and self.error is None:
                    try:
                        path, flavor, self.png_error = build()
                        try:
                            lib = ctypes.CDLL(path)
                        except OSError as e:  # a PNG library built where libpng is, loaded where it is not
                            if flavor != "png":
                                raise
                            path, flavor, self.png_error = _build_resize(None, f"the png library does not load: {e}")
                            lib = ctypes.CDLL(path)
                    except (RuntimeError, OSError) as e:  # OSError: no g++, or a library that does not load
                        self.error = str(e)
                    else:
                        _declare(lib, flavor)
                        self.flavor = flavor  # before lib: a reader that sees lib sees its flavor
                        self.lib = lib
        return self.lib

    def require(self) -> ctypes.CDLL:
        lib = self.get()
        if lib is None:
            raise RuntimeError(f"native resample library unavailable:\n{self.error}")
        return lib


_LIBRARY = _Library()


def available() -> bool:
    """True iff the library is built and loaded and ``TEDM_NATIVE`` is not 0."""
    return os.environ.get("TEDM_NATIVE", "1") != "0" and _LIBRARY.get() is not None


def png_available() -> bool:
    """True iff ``available()`` and the library was linked against libpng."""
    return available() and _LIBRARY.flavor == "png"


def flavor() -> Optional[str]:
    """The loaded library's flavor (``png`` or ``resize``), None if none loads."""
    _LIBRARY.get()
    return _LIBRARY.flavor


def png_error() -> Optional[str]:
    """g++'s output where the PNG build failed and the resize-only library
    stands in; None otherwise."""
    _LIBRARY.get()
    return _LIBRARY.png_error


def resize_u8(img: np.ndarray, size: Tuple[int, int], filter: str = "bicubic") -> np.ndarray:
    """Resize an (H, W) uint8 image to ``size`` = (out_h, out_w), byte for
    byte ``PIL.Image.fromarray(img).resize((out_w, out_h), <filter>)``."""
    lib = _LIBRARY.require()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected (H, W) uint8, got {img.shape}")
    oh, ow = size
    out = np.empty((oh, ow), np.uint8)
    rc = lib.tedm_resize_u8(img.ctypes.data_as(_U8P), img.shape[0], img.shape[1], out.ctypes.data_as(_U8P),
                            oh, ow, FILTERS[filter])
    if rc != 0:
        raise RuntimeError(f"tedm_resize_u8 failed: {rc}")
    return out


def resize_batch_u8(imgs: np.ndarray, size: Tuple[int, int], filter: str = "bicubic",
                    num_threads: Optional[int] = None) -> np.ndarray:
    """Resize a (B, H, W) uint8 stack to (B, out_h, out_w) across
    ``num_threads`` threads (default: one an image, at most one a core)."""
    lib = _LIBRARY.require()
    imgs = np.ascontiguousarray(imgs, dtype=np.uint8)
    if imgs.ndim != 3:
        raise ValueError(f"expected (B, H, W) uint8, got {imgs.shape}")
    oh, ow = size
    b = imgs.shape[0]
    out = np.empty((b, oh, ow), np.uint8)
    rc = lib.tedm_resize_batch_u8(imgs.ctypes.data_as(_U8P), b, imgs.shape[1], imgs.shape[2],
                                  out.ctypes.data_as(_U8P), oh, ow, FILTERS[filter],
                                  num_threads or min(b, os.cpu_count() or 1))
    if rc != 0:
        raise RuntimeError(f"tedm_resize_batch_u8 failed: {rc}")
    return out


def load_resize_png(path: str, size: Tuple[int, int], filter: str = "bicubic") -> Optional[np.ndarray]:
    """Decode a PNG, convert it to PIL's 'L' and resize it: byte for byte
    ``Image.open(path).convert('L').resize((out_w, out_h))``. None where the
    library has no PNG route or the file does not decode (the caller then
    reads it with PIL)."""
    lib = _LIBRARY.get()
    if lib is None or _LIBRARY.flavor != "png":
        return None
    oh, ow = size
    out = np.empty((oh, ow), np.uint8)
    rc = lib.tedm_png_decode_resize(os.fsencode(path), out.ctypes.data_as(_U8P), oh, ow, FILTERS[filter])
    return out if rc == 0 else None


def load_resize_png_batch(paths: Sequence[str], size: Tuple[int, int], filter: str = "bicubic",
                          num_threads: Optional[int] = None):
    """``load_resize_png`` of every path in one call, across C++ threads
    without the GIL. Returns (out (B, out_h, out_w) uint8, ok (B,) bool), or
    (None, None) without a PNG route; a row with ``ok`` False did not decode
    and must be read by the caller."""
    lib = _LIBRARY.get()
    if lib is None or _LIBRARY.flavor != "png":
        return None, None
    oh, ow = size
    n = len(paths)
    out = np.empty((n, oh, ow), np.uint8)
    status = (ctypes.c_int * n)()
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.tedm_png_decode_resize_batch(c_paths, n, out.ctypes.data_as(_U8P), oh, ow, FILTERS[filter],
                                     num_threads or min(n, os.cpu_count() or 1), status)
    return out, np.array([status[i] == 0 for i in range(n)], bool)
