"""Dataset readers (host side, numpy, NHWC): the port's own copy of
``tedm_tpu/data/datasets.py``.

Each dataset returns ``(img, mask)`` float32 NHWC arrays in [0, 1] (mask
binary), or just ``img`` for the unlabelled CXR14 corpus, with the
preprocessing of the reference:

* JSRT       - reference: dataloaders/JSRT.py:49-94. CSV cols: path, id;
               masks at SCR/masks/{right lung,left lung}/<id>.gif,
               binarised > 0.5 and summed (an overlap re-binarises).
* CXR14      - reference: dataloaders/CXR14.py:49-74. CSV col: 'Image Index';
               image only.
* NIH        - reference: dataloaders/NIH.py:14-50. CSV cols: scan, mask.
* Montgomery - reference: dataloaders/Montgomery.py:15-61. CSV cols: scan
               and the per-lung mask columns 'right lung', 'left lung'.
* Synthetic  - the deterministic pseudo-CXR generator, bit-equal to the JAX
               package's for the same (split, seed, index, size), so both
               packages train on the same corpus.

Images are decoded and resized as the JAX package's readers do: by the
native library (``tedm_tpu_torch/native``: libpng and Pillow's resampling in
C++) where it is built, else by PIL, which gives the same bytes; CXR14's
``get_batch`` reads a whole batch in one native call. The split CSVs in
``splits/`` are copies of the JAX package's, read with the ``csv`` module:
every value stays the string the file holds (JSRT ids such as ``JPCLN001``).
"""

from __future__ import annotations

import csv
import functools
import os
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

SPLITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "splits")


def read_rows(splits_dir: str, csv_name: str) -> List[Dict[str, str]]:
    """The rows of a split CSV, each a dict of column -> string."""
    with open(os.path.join(splits_dir, csv_name), newline="") as f:
        return list(csv.DictReader(f))


def _load_pil_image(path: str, img_size: int) -> np.ndarray:
    """PIL ``convert('L').resize((s, s))`` then ToTensor semantics (/255), as
    (H, W, 1) float32 (reference: dataloaders/JSRT.py:62-65). JAX's three
    routes in its order: a native PNG decode and resize; else a PIL decode
    and a native resize; else PIL alone. All give the same bytes."""
    from PIL import Image

    from tedm_tpu_torch import native

    arr8 = None
    if path.lower().endswith(".png") and native.png_available():
        arr8 = native.load_resize_png(path, (img_size, img_size))
    if arr8 is None:
        with Image.open(path) as img:
            gray = img.convert("L")
        if native.available():
            arr8 = native.resize_u8(np.asarray(gray, dtype=np.uint8), (img_size, img_size))
        else:
            arr8 = np.asarray(gray.resize((img_size, img_size)), dtype=np.uint8)
    return arr8.astype(np.float32)[..., None] / 255.0


def _load_mask(paths: Sequence[str], img_size: int) -> np.ndarray:
    """Binarise each mask at > 0.5 and sum; where the lungs overlap,
    re-binarise (reference: dataloaders/JSRT.py:67-88)."""
    masks = [(_load_pil_image(p, img_size) > 0.5).astype(np.float32) for p in paths]
    m = np.sum(masks, axis=0)
    if (m > 1).sum() > 0:
        m = (m > 0.5).astype(np.float32)
    return m


class JSRTDataset:
    def __init__(
        self,
        base_path: str,
        csv_name: str,
        img_size: int = 128,
        labels: Sequence[str] = ("right lung", "left lung"),
        splits_dir: str = SPLITS_DIR,
    ):
        self.rows = read_rows(splits_dir, csv_name)
        self.base_path = base_path
        self.labels = list(labels)
        self.img_size = img_size
        self.has_labels = True

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        row = self.rows[index]
        img = _load_pil_image(os.path.join(self.base_path, row["path"]), self.img_size)
        mask_paths = [os.path.join(self.base_path, "SCR", "masks", lab, row["id"] + ".gif") for lab in self.labels]
        return img, _load_mask(mask_paths, self.img_size)


class CXR14Dataset:
    """The unlabelled DDPM corpus. The reference's val/test quirk (all three
    loaders read train_split.csv, dataloaders/CXR14.py:30-32) is kept in
    ``build_dataloaders``."""

    def __init__(self, data_path: str, csv_name: str = "train_split.csv",
                 img_size: int = 128, splits_dir: str = SPLITS_DIR):
        self.rows = read_rows(splits_dir, csv_name)
        self.data_path = data_path
        self.img_size = img_size
        self.has_labels = False

    def __len__(self) -> int:
        return len(self.rows)

    def _path(self, index: int) -> str:
        return os.path.join(self.data_path, self.rows[index]["Image Index"])

    def __getitem__(self, index: int) -> np.ndarray:
        return _load_pil_image(self._path(index), self.img_size)

    def get_batch(self, indices: Sequence[int], map_fn: Callable = map) -> np.ndarray:
        """The images of ``indices`` as (B, H, W, 1), equal to
        ``__getitem__`` of each: one native call decodes and resizes every
        PNG across C++ threads without the GIL. A row it refuses, and every
        row where the library has no PNG route, is read by
        ``_load_pil_image`` through ``map_fn`` (the ``Loader`` passes its
        thread pool's ``map``)."""
        from tedm_tpu_torch import native

        paths = [self._path(i) for i in indices]
        load = functools.partial(_load_pil_image, img_size=self.img_size)
        if native.png_available() and all(p.lower().endswith(".png") for p in paths):
            out, ok = native.load_resize_png_batch(paths, (self.img_size, self.img_size))
            imgs = out.astype(np.float32)[..., None] / 255.0
            refused = np.flatnonzero(~ok)
            for j, img in zip(refused, map_fn(load, [paths[j] for j in refused])):
                imgs[j] = img
            return imgs
        return np.stack(list(map_fn(load, paths)))


class NIHDataset:
    def __init__(self, base_path: str, csv_name: str = "correspondence_with_chestXray8.csv",
                 img_size: int = 128, splits_dir: str = SPLITS_DIR):
        self.rows = read_rows(splits_dir, csv_name)
        self.base_path = base_path
        self.img_size = img_size
        self.has_labels = True

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        row = self.rows[index]
        img = _load_pil_image(os.path.join(self.base_path, row["scan"]), self.img_size)
        mask = (_load_pil_image(os.path.join(self.base_path, row["mask"]), self.img_size) > 0.5).astype(np.float32)
        return img, mask


class MonDataset:
    def __init__(self, base_path: str, csv_name: str, img_size: int = 128,
                 labels: Sequence[str] = ("right lung", "left lung"),
                 splits_dir: str = SPLITS_DIR):
        self.rows = read_rows(splits_dir, csv_name)
        self.base_path = base_path
        self.labels = list(labels)
        self.img_size = img_size
        self.has_labels = True

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        row = self.rows[index]
        img = _load_pil_image(os.path.join(self.base_path, row["scan"]), self.img_size)
        mask_paths = [os.path.join(self.base_path, row[lab]) for lab in self.labels]
        return img, _load_mask(mask_paths, self.img_size)


class SyntheticCXRDataset:
    """Deterministic pseudo chest X-rays with elliptical lung fields.

    Image = smooth body background + brighter thorax + two dark elliptical
    lungs + rib-like sinusoidal bands + speckle noise; mask = union of the
    two ellipses. Every sample is a pure function of (split, index, size),
    so runs are reproducible across hosts and processes.
    """

    def __init__(self, split: str = "train", n: int = 256, img_size: int = 128,
                 labelled: bool = True, seed: int = 0, hard: bool = False):
        self.split = split
        self.n = n
        self.img_size = img_size
        self.has_labels = labelled
        self.seed = seed
        self.hard = hard
        # shared per-instance constants (recomputing the meshgrid and body
        # background per image made the host pipeline the training
        # bottleneck: 114 imgs/s fed vs 262 imgs/s device capability)
        s = img_size
        self._yy, self._xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        self._body = 0.25 + 0.35 * np.exp(
            -(((self._yy - 0.5) ** 2) / 0.5 + ((self._xx - 0.5) ** 2) / 0.25)
        )

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int):
        import zlib

        s = self.img_size
        # crc32, not hash(): str hashing is salted per process, which would
        # break the documented cross-process/host determinism
        base = zlib.crc32(f"{self.split}:{self.seed}".encode()) % (2**31 - 1)
        rs = np.random.RandomState((base + 1000003 * index) % (2**31 - 1))
        yy, xx = self._yy, self._xx
        if self.hard:
            return self._render_hard(rs, s, yy, xx)

        img = self._body.copy()
        mask = np.zeros((s, s), np.float32)
        for side in (-1.0, 1.0):
            cx = 0.5 + side * (0.21 + 0.03 * rs.randn())
            cy = 0.48 + 0.03 * rs.randn()
            rx = 0.13 + 0.02 * rs.rand()
            ry = 0.26 + 0.03 * rs.rand()
            theta = 0.12 * side + 0.05 * rs.randn()
            xr = (xx - cx) * np.cos(theta) - (yy - cy) * np.sin(theta)
            yr = (xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
            lung = ((xr / rx) ** 2 + (yr / ry) ** 2) < 1.0
            mask = np.maximum(mask, lung.astype(np.float32))
            img = np.where(lung, img - 0.18 - 0.04 * rs.rand(), img)
        img = img + 0.03 * np.sin(yy * (40 + 5 * rs.rand()) + xx * 3)  # ribs
        img = img + 0.02 * rs.randn(s, s).astype(np.float32)  # speckle
        img = np.clip(img, 0.0, 1.0).astype(np.float32)[..., None]
        if not self.has_labels:
            return img
        return img, mask[..., None]

    def _render_hard(self, rs, s: int, yy, xx):
        """The HARD variant (VERDICT r3 #2): the easy corpus saturates —
        baseline n=1 hits 99.5 Dice, so the paper's central low-n ordering
        (diffusion features >= supervised, reference app.py:181-188) is
        untestable on it. Difficulty here comes from the failure modes of
        real CXR segmentation: weak, spatially-varying lung contrast under a
        multiplicative bias field; soft (partial-volume) lung boundaries;
        occluding high-contrast ribs and clavicles; cardiac and diaphragm
        shadows eating the medial/basal lung borders; vascular interior
        texture; and per-image brightness/contrast/gamma jitter. A single
        labeled image no longer covers the appearance distribution, which is
        exactly the regime TEDM targets.

        Same determinism contract as the easy path (pure function of
        (split, seed, index)), and lungs stay strictly on their side of the
        x=0.5 midline so the parity exporter's per-lung column partition
        stays exact (scripts/parity/export_data.py)."""
        # -- per-image multiplicative bias field (3 low-frequency bumps)
        bias = np.ones((s, s), np.float32)
        for _ in range(3):
            bx, by = rs.rand(), rs.rand()
            sx, sy = 0.2 + 0.3 * rs.rand(), 0.2 + 0.3 * rs.rand()
            amp = 0.35 * (rs.rand() - 0.5)
            bias += amp * np.exp(
                -(((xx - bx) / sx) ** 2 + ((yy - by) / sy) ** 2)
            ).astype(np.float32)
        img = self._body * bias

        mask = np.zeros((s, s), np.float32)
        lung_soft_all = np.zeros((s, s), np.float32)
        for side in (-1.0, 1.0):
            cx = 0.5 + side * (0.21 + 0.025 * rs.randn())
            cy = 0.47 + 0.035 * rs.randn()
            rx = 0.12 + 0.03 * rs.rand()
            ry = 0.24 + 0.05 * rs.rand()
            theta = 0.12 * side + 0.06 * rs.randn()
            xr = (xx - cx) * np.cos(theta) - (yy - cy) * np.sin(theta)
            yr = (xx - cx) * np.sin(theta) + (yy - cy) * np.cos(theta)
            d = (xr / rx) ** 2 + (yr / ry) ** 2
            # hard label; per-side half-plane keeps the midline partition
            # exact even for extreme draws
            halfplane = (xx < 0.5) if side < 0 else (xx >= 0.5)
            lung = ((d < 1.0) & halfplane).astype(np.float32)
            mask = np.maximum(mask, lung)
            # soft interior: partial-volume edge + vertical depth gradient
            edge_w = 0.10 + 0.10 * rs.rand()
            soft = (
                1.0 / (1.0 + np.exp(np.clip(-(1.0 - d) / edge_w, -60.0, 60.0)))
            ).astype(np.float32)
            soft *= halfplane
            depth = 0.09 + 0.06 * rs.rand()  # much weaker than easy's 0.18-0.22
            grad = 1.0 - 0.5 * np.clip((yr / max(ry, 1e-6) + 1.0) * 0.5, 0, 1)
            img -= depth * soft * grad
            lung_soft_all = np.maximum(lung_soft_all, soft)

        # -- cardiac shadow: bright ellipse low-center, biased left (x>0.5
        #    is the anatomical left on a frontal CXR), overlapping the
        #    medial lung border
        hx = 0.5 + 0.06 + 0.03 * rs.randn()
        hy = 0.62 + 0.04 * rs.randn()
        hd = ((xx - hx) / (0.16 + 0.04 * rs.rand())) ** 2 + (
            (yy - hy) / (0.14 + 0.04 * rs.rand())
        ) ** 2
        def _sigmoid(z):
            # numerically safe (exp of clipped arg; exact in float32 range)
            return 1.0 / (1.0 + np.exp(np.clip(-z, -60.0, 60.0)))

        img += (0.10 + 0.06 * rs.rand()) * _sigmoid((1.0 - hd) / 0.25)

        # -- diaphragm: bright below a random parabolic dome, soft edge
        dome = (0.70 + 0.05 * rs.randn()) + (0.12 + 0.08 * rs.rand()) * (
            (xx - 0.5) ** 2 * 4.0 - 0.4
        )
        img += (0.12 + 0.05 * rs.rand()) * _sigmoid(
            (yy - dome) / (0.02 + 0.02 * rs.rand())
        )

        # -- ribs: 5 bright curved bands crossing the thorax (stronger than
        #    the lung contrast locally -> true occluders)
        n_ribs = 5
        for k in range(n_ribs):
            y0 = 0.18 + 0.13 * k + 0.02 * rs.randn()
            curv = 0.10 + 0.06 * rs.rand()
            width = 0.010 + 0.008 * rs.rand()
            amp = 0.06 + 0.06 * rs.rand()
            ribline = y0 + curv * ((xx - 0.5) ** 2 * 4.0 - 0.5)
            img += amp * np.exp(-(((yy - ribline) / width) ** 2)).astype(np.float32)
        # -- clavicles: two steep bands at the apices
        for side in (-1.0, 1.0):
            c0 = 0.16 + 0.02 * rs.randn()
            slope = side * (0.25 + 0.1 * rs.rand())
            cl = c0 + slope * (xx - 0.5)
            img += (0.05 + 0.04 * rs.rand()) * np.exp(
                -(((yy - cl) / 0.012) ** 2)
            ).astype(np.float32)

        # -- vascular texture: subtle signed streaks, bled PAST the lung
        #    boundary (a blurred weight) so local variance doesn't betray
        #    the edge
        streak = rs.randn(s, s).astype(np.float32)
        k1 = np.ones((1, max(s // 16, 1)), np.float32)
        from scipy import ndimage as _nd

        streak = _nd.convolve(streak, k1 / k1.size, mode="wrap")
        streak = _nd.gaussian_filter(streak, sigma=max(s / 64.0, 1.0))
        fade = _nd.gaussian_filter(lung_soft_all, sigma=max(s / 24.0, 1.0))
        img += (0.35 + 0.25 * rs.rand()) * streak * np.clip(fade, 0.0, 1.0)

        # -- per-image brightness/contrast/gamma jitter
        img = 0.5 + (img - 0.5) * (0.65 + 0.5 * rs.rand())
        img = img + 0.10 * (rs.rand() - 0.5)
        img = np.clip(img, 0.0, 1.0) ** (0.7 + 0.6 * rs.rand())

        # -- speckle
        img = img + 0.025 * rs.randn(s, s).astype(np.float32)
        img = np.clip(img, 0.0, 1.0).astype(np.float32)[..., None]
        if not self.has_labels:
            return img
        return img, mask[..., None]
