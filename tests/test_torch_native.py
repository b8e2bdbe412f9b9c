"""The port's host image path (``tedm_tpu_torch/native``) on the CPU, byte for
byte against PIL and against the JAX package's library (``tedm_tpu.native``):
``resize_u8`` at six shapes and three filters; ``resize_batch_u8`` against
single calls; the PNG route on seven modes, one file at a time and as a
batch; the GIF mask path; two processes building into one empty build
directory at once; a failed build's g++ output in ``resize_u8``'s error;
a PNG build that does not link, or a PNG library that does not load,
falling back to the resize-only library; a built library loaded where
there is no g++;
``TEDM_NATIVE=0``; an import that brings in neither JAX, ``tedm_tpu`` nor
torch and builds nothing; the C++ sources as copies of JAX's.

The library is built with g++ at first use. These tests skip only where no
g++ is on ``PATH``; where g++ is there and the build fails, they fail."""

import hashlib
import os
import shutil
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from tedm_tpu import native as jnative
from tedm_tpu_torch import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [
    ((256, 256), (128, 128)),    # 2x down (the training size)
    ((2048, 2048), (128, 128)),  # JSRT's own size down
    ((100, 173), (128, 128)),    # not square, up in one axis, down in the other
    ((64, 64), (128, 128)),      # up
    ((128, 128), (128, 128)),    # identity
    ((131, 67), (37, 91)),       # odd sizes both ways
]
FILTERS = [("bicubic", Image.BICUBIC), ("bilinear", Image.BILINEAR), ("nearest", Image.NEAREST)]
PNG_MODES = ["gray8", "gray16", "gray16_alpha", "rgb", "rgba", "palette", "bit1"]
OUT = (48, 64)  # (out_h, out_w) of the PNG cases


@pytest.fixture(scope="module")
def built():
    """The port's library, built; a skip only where there is no g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native library is built with g++")
    if not native.available():
        pytest.fail(f"the native library did not build:\n{native._LIBRARY.error}")
    assert native.flavor() == "png", "g++ finds no png.h here: the PNG route would go untested"
    return native


def _rand(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)


def _pil(path, size, filt=Image.BICUBIC):
    oh, ow = size
    with Image.open(path) as img:
        return np.asarray(img.convert("L").resize((ow, oh), filt))


@pytest.mark.parametrize("in_shape,out_shape", SIZES)
@pytest.mark.parametrize("filt,pil_filt", FILTERS)
def test_resize_u8_equals_pil_and_jax(built, in_shape, out_shape, filt, pil_filt):
    img = _rand(in_shape, seed=sum(in_shape) + sum(out_shape))
    oh, ow = out_shape
    got = native.resize_u8(img, (oh, ow), filter=filt)
    assert got.dtype == np.uint8 and got.shape == (oh, ow)
    np.testing.assert_array_equal(got, np.asarray(Image.fromarray(img).resize((ow, oh), pil_filt)))
    np.testing.assert_array_equal(got, jnative.resize_u8(img, (oh, ow), filter=filt))


def test_resize_batch_u8_equals_single_calls(built):
    imgs = _rand((6, 211, 190), seed=11)
    singles = np.stack([native.resize_u8(im, (128, 96)) for im in imgs])
    np.testing.assert_array_equal(singles[0], np.asarray(Image.fromarray(imgs[0]).resize((96, 128))))  # PIL's default
    for threads in (None, 1, 3):
        np.testing.assert_array_equal(native.resize_batch_u8(imgs, (128, 96), num_threads=threads), singles)
    for filt, _ in FILTERS:
        np.testing.assert_array_equal(native.resize_batch_u8(imgs, (37, 91), filt, num_threads=4),
                                      jnative.resize_batch_u8(imgs, (37, 91), filt, num_threads=2))
    with pytest.raises(ValueError, match="expected"):
        native.resize_batch_u8(imgs[0], (8, 8))


def _gray16_alpha_png(path, rs):
    """A 16-bit gray + alpha PNG written by hand (PIL writes no LA;16B)."""
    g = rs.randint(0, 2**16, (70, 50), np.uint16)
    ga = np.stack([g, np.full_like(g, 65535)], axis=-1).astype(">u2")
    raw = b"".join(b"\x00" + row.tobytes() for row in ga)

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 50, 70, 16, 4, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _png(tmp_path, mode):
    """One PNG of ``mode``, as a reader may meet it."""
    rs = np.random.RandomState(PNG_MODES.index(mode))
    path = tmp_path / f"{mode}.png"
    rgb = Image.fromarray(rs.randint(0, 256, (150, 200, 3), np.uint8), "RGB")
    if mode == "gray16_alpha":
        _gray16_alpha_png(path, rs)
        return str(path)
    img = {
        "gray8": lambda: Image.fromarray(rs.randint(0, 256, (220, 180), np.uint8), "L"),
        "gray16": lambda: Image.fromarray(rs.randint(0, 2**16, (120, 90)).astype(np.uint16)),  # I;16
        "rgb": lambda: rgb,
        "rgba": lambda: Image.fromarray(rs.randint(0, 256, (150, 200, 4), np.uint8), "RGBA"),
        "palette": lambda: rgb.convert("P", palette=Image.ADAPTIVE),
        "bit1": lambda: Image.fromarray(rs.randint(0, 256, (99, 77), np.uint8), "L").convert("1"),
    }[mode]()
    img.save(path)
    return str(path)


@pytest.mark.parametrize("mode", PNG_MODES)
def test_png_route_equals_pil_and_jax(built, tmp_path, mode):
    path = _png(tmp_path, mode)
    got = native.load_resize_png(path, OUT)
    assert got is not None, f"{mode} did not decode natively"
    np.testing.assert_array_equal(got, _pil(path, OUT), err_msg=mode)
    np.testing.assert_array_equal(got, jnative.load_resize_png(path, OUT), err_msg=mode)


def test_png_batch_equals_pil_and_jax_and_reports_refused_rows(built, tmp_path):
    paths = [_png(tmp_path, m) for m in PNG_MODES]
    gif_named_png = tmp_path / "gif.png"  # PIL reads it by its content; libpng refuses it
    Image.fromarray(_rand((40, 30), seed=5)).save(gif_named_png, format="GIF")
    paths += [str(tmp_path / "missing.png"), str(gif_named_png)]
    out, ok = native.load_resize_png_batch(paths, OUT, num_threads=3)
    want_out, want_ok = jnative.load_resize_png_batch(paths, OUT, num_threads=2)
    assert ok.tolist() == want_ok.tolist() == [True] * len(PNG_MODES) + [False, False]
    np.testing.assert_array_equal(out[ok], want_out[ok])
    for i, p in enumerate(paths[:len(PNG_MODES)]):
        np.testing.assert_array_equal(out[i], _pil(p, OUT), err_msg=PNG_MODES[i])
    assert native.load_resize_png(str(gif_named_png), OUT) is None


def test_gif_mask_path_equals_pil_and_jax(built, tmp_path):
    """A lung mask as the readers meet it: a GIF, decoded by PIL (the PNG
    route refuses it), its 'L' bytes resized natively."""
    rs = np.random.RandomState(3)
    mask = (rs.rand(247, 247) > 0.5).astype(np.uint8) * 255
    mask[:40] = 100  # a grey band below the readers' threshold
    path = tmp_path / "m.gif"
    Image.fromarray(mask).save(path)
    assert native.load_resize_png(str(path), (128, 128)) is None
    with Image.open(path) as img:
        gray = np.asarray(img.convert("L"), np.uint8)
    got = native.resize_u8(gray, (128, 128))
    np.testing.assert_array_equal(got, _pil(path, (128, 128)))
    np.testing.assert_array_equal(got, jnative.resize_u8(gray, (128, 128)))


def test_tedm_native_0_turns_the_library_off_at_each_call(built, monkeypatch):
    monkeypatch.setenv("TEDM_NATIVE", "0")
    assert native.available() is False and native.png_available() is False
    monkeypatch.setenv("TEDM_NATIVE", "1")
    assert native.available() is True and native.png_available() is True


BUILD_CHILD = """
import sys
import numpy as np
from PIL import Image
from tedm_tpu_torch import native
native.BUILD_DIR = sys.argv[1]
assert native.png_available(), native._LIBRARY.error
img = np.random.RandomState(0).randint(0, 256, (90, 70), np.uint8)
assert (native.resize_u8(img, (32, 40)) == np.asarray(Image.fromarray(img).resize((40, 32)))).all()
print(native.library_path(native.flavor()))
"""


def test_two_processes_building_at_once_both_load(built, tmp_path):
    build_dir = tmp_path / "_build"
    build_dir.mkdir()
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_CHILD, str(build_dir)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lib = native.library_path("png", str(build_dir))
    assert [o.strip() for o, _ in outs] == [lib, lib]
    assert os.listdir(build_dir) == [os.path.basename(lib)]  # no temp file left behind


def test_a_failed_build_keeps_gpp_output(built, monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag-here",))
    monkeypatch.setattr(native, "_LIBRARY", native._Library())
    assert native.available() is False and native.png_available() is False
    with pytest.raises(RuntimeError, match="unrecognized command-line option") as err:
        native.resize_u8(np.zeros((4, 4), np.uint8), (2, 2))
    assert "-fno-such-flag-here" in str(err.value)
    assert "the png library" in str(err.value) and "the resize library" in str(err.value)  # both flavors' output
    assert native.load_resize_png(str(tmp_path / "x.png"), (2, 2)) is None
    assert os.listdir(tmp_path) == []  # the failed builds left no temp file


def test_a_png_build_that_does_not_link_falls_back_to_resize(built, monkeypatch, tmp_path):
    """Headers but no libpng to link: the resize-only library stands in,
    with the PNG build's g++ output kept, as JAX's build falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "FLAVORS", {**native.FLAVORS, "png": (native.SOURCES, ("-lno_such_library_here",))})
    monkeypatch.setattr(native, "_LIBRARY", native._Library())
    assert native.available() is True and native.png_available() is False and native.flavor() == "resize"
    assert "no_such_library_here" in native.png_error()
    assert native.load_resize_png(str(tmp_path / "x.png"), (2, 2)) is None
    img = _rand((90, 70), seed=4)
    np.testing.assert_array_equal(native.resize_u8(img, (32, 40)), np.asarray(Image.fromarray(img).resize((40, 32))))
    assert os.listdir(tmp_path) == [os.path.basename(native.library_path("resize"))]


def test_a_png_library_that_does_not_load_falls_back_to_resize(built, monkeypatch, tmp_path):
    """A PNG library built where libpng is and copied where it is not."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    with open(native.library_path("png"), "wb") as f:
        f.write(b"not a shared object")
    monkeypatch.setattr(native, "_LIBRARY", native._Library())
    assert native.available() is True and native.png_available() is False and native.flavor() == "resize"
    assert "the png library does not load" in native.png_error()
    img = _rand((90, 70), seed=6)
    np.testing.assert_array_equal(native.resize_u8(img, (32, 40)), np.asarray(Image.fromarray(img).resize((40, 32))))


def test_a_built_resize_library_loads_without_gpp(built, monkeypatch, tmp_path):
    resize = native.library_path("resize", str(tmp_path))
    native._compile("resize", resize)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("PATH", "")  # no g++
    monkeypatch.setattr(native, "_LIBRARY", native._Library())
    assert native.available() is True and native.flavor() == "resize" and native.png_error() is None
    os.unlink(resize)
    monkeypatch.setattr(native, "_LIBRARY", native._Library())
    assert native.available() is False
    with pytest.raises(RuntimeError, match="no g\\+\\+ on PATH"):
        native.resize_u8(np.zeros((4, 4), np.uint8), (2, 2))


def test_the_library_is_built_into_the_ports_build_dir(built):
    port = os.path.join(REPO, "tedm_tpu_torch")
    assert native.BUILD_DIR == os.path.join(port, "_build")
    assert os.path.isfile(native.library_path("png"))
    own = sorted(f for f in os.listdir(os.path.join(port, "native")) if f != "__pycache__")
    assert own == ["__init__.py", "cc"] and sorted(os.listdir(native.CC)) == sorted(native.SOURCES)


def test_import_brings_in_neither_jax_tedm_tpu_nor_torch_and_builds_nothing():
    code = ("import sys, tedm_tpu_torch.native as n; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tedm_tpu', 'torch')), "
            "n._LIBRARY.lib, n._LIBRARY.error)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[] None None", out.stderr


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("name", native.SOURCES)
def test_cc_sources_are_copies_of_the_jax_packages(name):
    jax_cc = os.path.join(REPO, "tedm_tpu", "native", "cc")
    assert _sha(os.path.join(native.CC, name)) == _sha(os.path.join(jax_cc, name))
