"""Split generation (port of ``tedm_tpu/data/make_splits.py``; pandas is
imported by ``main``; reference: auxiliary/preprocessing/
JSRT_preprocessing_separate_data.py and
CXR14_preprocessing_separate_data.py): shuffle the source metadata CSV
and write 80/10/10 train/val/test splits.

    python -m tedm_tpu_torch.data.make_splits jsrt  --data_dir <JSRT dir>  [--out DIR] [--seed N]
    python -m tedm_tpu_torch.data.make_splits cxr14 --data_dir <CXR14 dir> [--out DIR] [--seed N]

The shipped splits under tedm_tpu_torch/data/splits/ are copied verbatim from
the reference's data/ directory (197/25/25 JSRT; ~89.7k CXR14), so this
is only needed to regenerate splits from raw downloads. Unlike the
reference notebooks, the shuffle is seeded."""

from __future__ import annotations

import argparse
import os

import numpy as np


def write_splits(df, out_dir: str, prefix: str, seed: int = 0) -> None:
    idx = np.arange(len(df))
    np.random.RandomState(seed).shuffle(idx)
    n1, n2 = int(len(df) * 0.8), int(len(df) * 0.9)
    parts = {"train": idx[:n1], "val": idx[n1:n2], "test": idx[n2:]}
    os.makedirs(out_dir, exist_ok=True)
    for name, rows in parts.items():
        path = os.path.join(out_dir, f"{prefix}{name}_split.csv")
        df.loc[df.index[rows]].to_csv(path, index=False)
        print(f"{path}: {len(rows)} rows")


def main(argv=None) -> None:
    import pandas as pd

    p = argparse.ArgumentParser()
    p.add_argument("dataset", choices=["jsrt", "cxr14"])
    p.add_argument("--data_dir", type=str, required=True)
    p.add_argument("--out", type=str, default=None,
                   help="output dir (default: the packaged splits dir)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(__file__)), "splits")

    if args.dataset == "jsrt":
        df = pd.read_csv(os.path.join(args.data_dir, "jsrt_metadata_with_masks.csv"))
        df.reset_index(inplace=True)
        write_splits(df, out, "JSRT_", args.seed)
    else:
        df = pd.concat([
            pd.read_csv(os.path.join(args.data_dir, "train_val_list.csv")),
            pd.read_csv(os.path.join(args.data_dir, "test_list.csv")),
        ])
        df.reset_index(inplace=True)
        missing = [
            f for f in df["Image Index"]
            if not os.path.isfile(os.path.join(args.data_dir, "images", f))
        ]
        if missing:
            print(f"warning: {len(missing)} listed images missing on disk")
        write_splits(df, out, "", args.seed)


if __name__ == "__main__":
    main()
