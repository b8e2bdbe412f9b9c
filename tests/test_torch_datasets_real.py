"""The port's readers of the real corpora against the JAX package's, on the
CPU: JSRT, CXR14, NIH and Montgomery read from PNG and GIF files written
into a temp dir give byte-equal arrays (source images off the output size,
masks with grey levels on both sides of the threshold, lung masks that
overlap); ``build_dataloaders`` gives equal batches over an epoch with a
subset of 3; each reader equals JAX's with the port's native library and
with ``TEDM_NATIVE=0``, and a CXR14 ``get_batch`` row that the native route
refuses is read back as PIL reads it; the port's split CSVs are byte copies
of the JAX package's; and ``scripts/port/export_corpus.py`` writes the files
that ``scripts/parity/export_data.py`` writes, byte for byte, at 16x16."""

import hashlib
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from tedm_tpu.data import datasets as jds
from tedm_tpu.data.pipeline import build_dataloaders as jax_build_dataloaders
from tedm_tpu_torch import native
from tedm_tpu_torch.data import datasets as ds
from tedm_tpu_torch.data.pipeline import build_dataloaders

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 16
SHAPES = [(37, 41), (16, 16), (64, 48), (23, 30)]  # (W, H) of each source image


def _png(path, w, h, rs):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray((rs.rand(h, w) * 255).astype(np.uint8), mode="L").save(path)


def _mask(path, w, h, x0, x1, grey=255):
    """A GIF mask: the columns [x0, x1) of the image at ``grey``, a band of
    grey 100 (below the threshold) beside it."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    a = np.zeros((h, w), np.uint8)
    a[h // 5:-h // 5, int(x0 * w):int(x1 * w)] = grey
    a[:h // 5, int(x0 * w):int(x1 * w)] = 100
    Image.fromarray(a, mode="L").save(path)


def _write_csv(path, header, rows):
    with open(path, "w") as f:
        f.write(",".join(header) + "\n")
        for r in rows:
            f.write(",".join(r) + "\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rs = np.random.RandomState(0)
    splits = root / "splits"
    splits.mkdir()
    # JSRT: ids as the reference's (strings with leading letters and zeros);
    # the right and left lungs of every other image overlap in the middle
    for split, n in (("train", 4), ("val", 3), ("test", 2)):
        rows = []
        for i in range(n):
            iid = f"JPC{split[:2].upper()}{i:03d}"
            w, h = SHAPES[i % len(SHAPES)]
            _png(str(root / "JSRT" / "PNG_data" / f"{iid}.png"), w, h, rs)
            overlap = 0.1 if i % 2 == 0 else 0.0
            _mask(str(root / "SCR" / "masks" / "right lung" / f"{iid}.gif"), w, h, 0.5 - overlap, 0.9)
            _mask(str(root / "SCR" / "masks" / "left lung" / f"{iid}.gif"), w, h, 0.1, 0.5 + overlap)
            rows.append((iid, f"JSRT/PNG_data/{iid}.png"))
        _write_csv(str(splits / f"JSRT_{split}_split.csv"), ("id", "path"), rows)
    # CXR14
    names = [f"0000{i}_000.png" for i in range(5)]
    for i, name in enumerate(names):
        _png(str(root / "CXR14" / name), *SHAPES[i % len(SHAPES)], rs)
    _write_csv(str(splits / "train_split.csv"), ("Image Index",), [(n,) for n in names])
    # NIH: one merged mask a scan, with the reference CSV's extra columns
    rows = []
    for i in range(3):
        w, h = SHAPES[i]
        _png(str(root / "NIH" / "images" / f"NIH_{i:04d}.png"), w, h, rs)
        _mask(str(root / "NIH" / "masks" / f"NIH_{i:04d}_mask.png"), w, h, 0.2, 0.7, grey=180)
        rows.append((f"NIH_{i:04d}", f"0000{i}_008.png", f"images/NIH_{i:04d}.png", f"masks/NIH_{i:04d}_mask.png"))
    _write_csv(str(splits / "correspondence_with_chestXray8.csv"), ("NIH", "ChestX-ray14", "scan", "mask"), rows)
    # Montgomery: per-lung masks, overlapping in image 0
    rows = []
    for i in range(3):
        w, h = SHAPES[i + 1]
        _png(str(root / "Mon" / "scans" / f"MCU_{i}.png"), w, h, rs)
        overlap = 0.15 if i == 0 else 0.0
        _mask(str(root / "Mon" / "right" / f"MCU_{i}.gif"), w, h, 0.5 - overlap, 0.8)
        _mask(str(root / "Mon" / "left" / f"MCU_{i}.gif"), w, h, 0.2, 0.5 + overlap)
        rows.append((f"scans/MCU_{i}.png", f"right/MCU_{i}.gif", f"left/MCU_{i}.gif"))
    _write_csv(str(root / "Mon" / "patient_data.csv"), ("scan", "right lung", "left lung"), rows)
    return root


def _readers(root):
    """(port reader, JAX reader) of each corpus, on the same files."""
    sdir = str(root / "splits")
    for name, args, kw in (
        ("JSRT_train", (str(root), "JSRT_train_split.csv", SIZE), {"splits_dir": sdir}),
        ("JSRT_val", (str(root), "JSRT_val_split.csv", SIZE), {"splits_dir": sdir}),
        ("CXR14", (str(root / "CXR14"), "train_split.csv", SIZE), {"splits_dir": sdir}),
        ("NIH", (str(root / "NIH"),), {"img_size": SIZE, "splits_dir": sdir}),
        ("Montgomery", (str(root / "Mon"), "patient_data.csv", SIZE), {"splits_dir": str(root / "Mon")}),
    ):
        cls = {"JSRT": "JSRTDataset", "CXR14": "CXR14Dataset", "NIH": "NIHDataset", "Montgomery": "MonDataset"}[
            name.split("_")[0]]
        yield name, getattr(ds, cls)(*args, **kw), getattr(jds, cls)(*args, **kw)


@pytest.mark.parametrize("which", ["JSRT_train", "JSRT_val", "CXR14", "NIH", "Montgomery"])
def test_readers_byte_equal_to_jax(corpus, which):
    ours, theirs = next((o, t) for n, o, t in _readers(corpus) if n == which)
    assert len(ours) == len(theirs) > 0 and ours.has_labels == theirs.has_labels
    overlapped = False
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        for x, y in zip(a if ours.has_labels else (a,), b if ours.has_labels else (b,)):
            assert x.dtype == y.dtype == np.float32 and x.shape == (SIZE, SIZE, 1)
            np.testing.assert_array_equal(x, y)
        if ours.has_labels:
            assert set(np.unique(a[1])) <= {0.0, 1.0} and a[1].any()
            if which != "NIH":  # the summed lungs overlap somewhere: re-binarised
                m = sum((ds._load_pil_image(p, SIZE) > 0.5) for p in _mask_paths(ours, i))
                overlapped |= bool((m > 1).any())
    assert overlapped or which in ("CXR14", "NIH")


@pytest.mark.parametrize("which", ["JSRT_train", "JSRT_val", "CXR14", "NIH", "Montgomery"])
@pytest.mark.parametrize("route", ["native", "pil"])
def test_readers_byte_equal_to_jax_on_each_route(corpus, which, route, monkeypatch):
    """The port's reader with its library and with ``TEDM_NATIVE=0``
    against JAX's reader with its library: the same bytes, and the route
    taken is the one asked for (PNGs decoded natively, GIF masks resized
    natively; neither where the library is off)."""
    ours, theirs = next((o, t) for n, o, t in _readers(corpus) if n == which)
    want = [theirs[i] for i in range(len(theirs))]
    calls = {"load_resize_png": 0, "resize_u8": 0}
    for fn in calls:
        def counted(*a, _fn=getattr(native, fn), _name=fn, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(native, fn, counted)
    monkeypatch.setenv("TEDM_NATIVE", "1" if route == "native" else "0")
    for i, b in enumerate(want):
        a = ours[i]
        for x, y in zip(a if ours.has_labels else (a,), b if ours.has_labels else (b,)):
            assert x.dtype == y.dtype == np.float32 and x.shape == (SIZE, SIZE, 1)
            np.testing.assert_array_equal(x, y)
    if route == "pil":
        assert calls == {"load_resize_png": 0, "resize_u8": 0}
    else:  # every image is a PNG; the JSRT and Montgomery lungs are GIFs
        assert calls["load_resize_png"] >= len(ours)
        assert (calls["resize_u8"] > 0) == (which.startswith("JSRT") or which == "Montgomery")


def test_get_batch_row_the_native_route_refuses_equals_pil(corpus, tmp_path):
    """A CXR14 file named .png whose content is a GIF: libpng refuses it in
    the batch call, and ``get_batch`` reads it back as PIL does; the other
    rows stay native, and the whole batch equals JAX's."""
    data = tmp_path / "CXR14"
    shutil.copytree(corpus / "CXR14", data)
    names = [r["Image Index"] for r in ds.read_rows(str(corpus / "splits"), "train_split.csv")]
    Image.open(data / names[2]).save(data / names[2], format="GIF")
    reader = ds.CXR14Dataset(str(data), "train_split.csv", SIZE, splits_dir=str(corpus / "splits"))
    _, ok = native.load_resize_png_batch([reader._path(i) for i in range(len(names))], (SIZE, SIZE))
    assert ok.tolist() == [i != 2 for i in range(len(names))]
    got = reader.get_batch(range(len(names)))
    assert got.dtype == np.float32 and got.shape == (len(names), SIZE, SIZE, 1)
    for i, name in enumerate(names):
        with Image.open(data / name) as img:
            pil = np.asarray(img.convert("L").resize((SIZE, SIZE)), np.uint8).astype(np.float32)[..., None] / 255.0
        np.testing.assert_array_equal(got[i], pil, err_msg=name)
    theirs = jds.CXR14Dataset(str(data), "train_split.csv", SIZE, splits_dir=str(corpus / "splits"))
    np.testing.assert_array_equal(got, theirs.get_batch(list(range(len(names)))))


def _mask_paths(reader, i):
    row = reader.rows[i]
    if isinstance(reader, ds.JSRTDataset):
        return [os.path.join(reader.base_path, "SCR", "masks", lab, row["id"] + ".gif") for lab in reader.labels]
    return [os.path.join(reader.base_path, row[lab]) for lab in reader.labels]


@pytest.mark.parametrize("dataset", ["JSRT", "CXR14"])
def test_build_dataloaders_batches_equal_jax_over_an_epoch(corpus, dataset):
    data_dir = str(corpus if dataset == "JSRT" else corpus / "CXR14")
    kw = dict(img_size=SIZE, batch_size=2, num_workers=2, n_labelled_images=3, seed=1,
              splits_dir=str(corpus / "splits"))
    ours, theirs = build_dataloaders(dataset, data_dir, **kw), jax_build_dataloaders(dataset, data_dir, **kw)
    for split in ("train", "val", "test"):
        assert len(ours[split].indices) == len(theirs[split].indices)
        got, want = list(ours[split]), list(theirs[split])
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    if dataset == "JSRT":  # the subset is the first 3 rows, two batches of them
        assert ours["train"].indices.tolist() == [0, 1, 2] and len(ours["train"]) == 2


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_split_csvs_are_copies_of_the_jax_packages():
    names = sorted(os.listdir(jds.SPLITS_DIR))
    assert len(names) == 7 and sorted(os.listdir(ds.SPLITS_DIR)) == names
    for name in names:
        assert _sha(os.path.join(ds.SPLITS_DIR, name)) == _sha(os.path.join(jds.SPLITS_DIR, name)), name
    rows = ds.read_rows(ds.SPLITS_DIR, "JSRT_train_split.csv")
    assert len(rows) == 197 and rows[0] == {"id": "JPCLN001", "path": "JSRT/PNG_data/JPCLN001.png"}


def test_export_corpus_writes_the_files_export_data_writes(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts", "parity"))
    sys.path.insert(0, os.path.join(REPO, "scripts", "port"))
    import export_corpus
    import export_data

    args = ["--img_size", "16", "--hard", "--n_cxr", "6", "--seed", "1"]
    export_data.main(["--root", str(tmp_path / "jax")] + args)
    export_corpus.main(["--root", str(tmp_path / "port")] + args)
    files = lambda root: sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)
    want = files(tmp_path / "jax")
    assert len(want) == 6 + 247 * 3 + 100 * 2 + 100 * 3 + 6 and files(tmp_path / "port") == want
    for f in want:
        assert _sha(tmp_path / "port" / f) == _sha(tmp_path / "jax" / f), f
