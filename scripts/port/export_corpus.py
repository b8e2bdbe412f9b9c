"""Write the synthetic chest X-ray corpus to disk in the reference's layout,
from the port's own ``SyntheticCXRDataset``: the files, names, CSV columns
and uint8 pixels of ``scripts/parity/export_data.py``, without pandas and
without the JAX package.

  <root>/JSRT/images/<id>.png            csv cols: path,id
  <root>/JSRT/SCR/masks/{right lung,left lung}/<id>.gif
  <root>/CXR14/<name>.png                csv col: 'Image Index'
  <root>/NIH/{scans,masks}/...           csv cols: scan,mask
  <root>/Montgomery/...                  csv cols: scan,'right lung','left lung'
  <root>/data/*.csv

The two lungs never cross the x = 0.5 midline, so a column partition there
gives disjoint per-lung masks whose binarise-and-sum in the readers gives
back the merged mask exactly.

    python scripts/port/export_corpus.py --root DIR --img_size 64 --hard [--n_cxr 512]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from tedm_tpu_torch.data.datasets import SyntheticCXRDataset  # noqa: E402


def _save_png(path: str, img01: np.ndarray) -> None:
    from PIL import Image

    arr = np.clip(np.round(img01[..., 0] * 255.0), 0, 255).astype(np.uint8)
    Image.fromarray(arr, mode="L").save(path)


def _save_gif(path: str, mask: np.ndarray) -> None:
    from PIL import Image

    arr = (mask[..., 0] > 0.5).astype(np.uint8) * 255
    Image.fromarray(arr, mode="L").save(path)


def _split_lungs(mask: np.ndarray) -> tuple:
    s = mask.shape[0]
    xx = np.arange(s)[None, :, None] / s
    left = mask * (xx < 0.5)
    right = mask * (xx >= 0.5)
    if not np.array_equal(np.maximum(left, right), mask):
        raise ValueError("a lung crosses the midline")
    return right, left  # ('right lung', 'left lung') column order


def _write_csv(path: str, columns: Sequence[str], rows: List[Dict[str, str]]) -> None:
    """A header and the rows, as ``pandas.DataFrame.to_csv(index=False)``
    writes them on Linux."""
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(columns), lineterminator="\n")
        w.writeheader()
        w.writerows(rows)


def export_jsrt(root: str, img_size: int, seed: int, hard: bool = False) -> None:
    base = os.path.join(root, "JSRT")
    os.makedirs(os.path.join(base, "images"), exist_ok=True)
    for lab in ("right lung", "left lung"):
        os.makedirs(os.path.join(base, "SCR", "masks", lab), exist_ok=True)
    for split, n in (("train", 197), ("val", 25), ("test", 25)):
        ds = SyntheticCXRDataset(split, n, img_size, labelled=True, seed=seed, hard=hard)
        rows = []
        for i in range(n):
            img, mask = ds[i]
            iid = f"{split}_{i:04d}"
            _save_png(os.path.join(base, "images", iid + ".png"), img)
            r, l = _split_lungs(mask)
            _save_gif(os.path.join(base, "SCR", "masks", "right lung", iid + ".gif"), r)
            _save_gif(os.path.join(base, "SCR", "masks", "left lung", iid + ".gif"), l)
            rows.append({"path": f"images/{iid}.png", "id": iid})
        _write_csv(os.path.join(root, "data", f"JSRT_{split}_split.csv"), ("path", "id"), rows)
        print(f"JSRT {split}: {n} images")


def export_cxr14(root: str, img_size: int, seed: int, n: int, hard: bool = False) -> None:
    base = os.path.join(root, "CXR14")
    os.makedirs(base, exist_ok=True)
    ds = SyntheticCXRDataset("cxr_train", n, img_size, labelled=False, seed=seed, hard=hard)
    rows = []
    for i in range(n):
        name = f"cxr_{i:05d}.png"
        _save_png(os.path.join(base, name), ds[i])
        rows.append({"Image Index": name})
    _write_csv(os.path.join(root, "data", "train_split.csv"), ("Image Index",), rows)
    print(f"CXR14: {n} images")


def export_crossdomain(root: str, img_size: int, seed: int, hard: bool = False, n: int = 100) -> None:
    """NIH and Montgomery, ``n`` images each (100: the reference sizes of both sets)."""
    # NIH: one merged mask a scan (reference csv cols scan, mask)
    base = os.path.join(root, "NIH")
    os.makedirs(os.path.join(base, "scans"), exist_ok=True)
    os.makedirs(os.path.join(base, "masks"), exist_ok=True)
    ds = SyntheticCXRDataset("nih", n, img_size, labelled=True, seed=seed, hard=hard)
    rows = []
    for i in range(n):
        img, mask = ds[i]
        _save_png(os.path.join(base, "scans", f"nih_{i:03d}.png"), img)
        _save_gif(os.path.join(base, "masks", f"nih_{i:03d}.gif"), mask)
        rows.append({"scan": f"scans/nih_{i:03d}.png", "mask": f"masks/nih_{i:03d}.gif"})
    _write_csv(os.path.join(root, "data", "correspondence_with_chestXray8.csv"), ("scan", "mask"), rows)
    print(f"NIH: {n} images")

    # Montgomery: per-lung mask columns (reference csv cols scan + labels)
    base = os.path.join(root, "Montgomery")
    os.makedirs(os.path.join(base, "scans"), exist_ok=True)
    for lab in ("right", "left"):
        os.makedirs(os.path.join(base, "masks", lab), exist_ok=True)
    ds = SyntheticCXRDataset("montgomery", n, img_size, labelled=True, seed=seed, hard=hard)
    rows = []
    for i in range(n):
        img, mask = ds[i]
        _save_png(os.path.join(base, "scans", f"mon_{i:03d}.png"), img)
        r, l = _split_lungs(mask)
        _save_gif(os.path.join(base, "masks", "right", f"mon_{i:03d}.gif"), r)
        _save_gif(os.path.join(base, "masks", "left", f"mon_{i:03d}.gif"), l)
        rows.append({
            "scan": f"scans/mon_{i:03d}.png",
            "right lung": f"masks/right/mon_{i:03d}.gif",
            "left lung": f"masks/left/mon_{i:03d}.gif",
        })
    _write_csv(os.path.join(root, "data", "patient_data.csv"), ("scan", "right lung", "left lung"), rows)
    print(f"Montgomery: {n} images")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, required=True)
    ap.add_argument("--img_size", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n_cxr", type=int, default=512)
    ap.add_argument("--n_crossdomain", type=int, default=100, help="images of NIH and of Montgomery each")
    ap.add_argument("--hard", action="store_true",
                    help="the hard corpus: weak contrast, soft boundaries, bias fields, occluders")
    args = ap.parse_args(argv)
    os.makedirs(os.path.join(args.root, "data"), exist_ok=True)
    export_jsrt(args.root, args.img_size, args.seed, hard=args.hard)
    export_cxr14(args.root, args.img_size, args.seed, args.n_cxr, hard=args.hard)
    export_crossdomain(args.root, args.img_size, args.seed, hard=args.hard, n=args.n_crossdomain)
    print(f"exported to {args.root}")


if __name__ == "__main__":
    main()
