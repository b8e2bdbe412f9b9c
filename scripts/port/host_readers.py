"""Time the ways the port's CXR14 reader can make a batch, on the host.

Writes a CXR14-layout corpus of PNGs (``export_corpus.py``'s writer, the
synthetic images at ``--side``) and reads batches of ``--batch`` at 128^2
through ``CXR14Dataset`` in each of these routes, in turns, ``--repeats``
times each:

* ``per_item_pool``: ``__getitem__`` of each row in a pool of ``--threads``
  threads (the ``Loader``'s per-item path; with libpng, one native decode a
  row, the GIL released inside the ctypes call);
* ``get_batch``: ``get_batch(indices, pool.map)``, the ``Loader``'s
  whole-batch path (with libpng one native call, its threads by default
  one an image, at most one a core);
* ``batch_call_at_threads``: the same single native call at ``--threads``
  threads, so it is held against the pool at one thread count;
* ``pil_pool`` and ``pil_serial``: ``TEDM_NATIVE=0``, ``get_batch``
  with the pool's ``map`` and with the builtin ``map`` (JAX's ``get_batch``
  reads such rows one after another).

Every route's batches must be byte-equal. Prints one JSON object: ms a
batch of each run, the medians, the library's flavor, Pillow's version and
the core count. The routes that need libpng are left out where the library
has no PNG route.

    python3 scripts/port/host_readers.py [--n 64] [--side 1024] [--threads 4]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def write_corpus(root: str, n: int, side: int, seed: int) -> str:
    import export_corpus as ec

    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset

    images, splits = os.path.join(root, "CXR14"), os.path.join(root, "data")
    os.makedirs(images)
    os.makedirs(splits)
    ds = SyntheticCXRDataset("cxr_train", n, side, labelled=False, seed=seed)
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(lambda i: ec._save_png(os.path.join(images, f"cxr_{i:05d}.png"), ds[i]), range(n)))
    ec._write_csv(os.path.join(splits, "train_split.csv"), ("Image Index",),
                  [{"Image Index": f"cxr_{i:05d}.png"} for i in range(n)])
    return root


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=64, help="PNG files in the corpus")
    p.add_argument("--side", type=int, default=1024, help="their side in pixels (CXR14's is 1024)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--threads", type=int, default=4, help="the pool's threads (the Loader's default num_workers)")
    p.add_argument("--repeats", type=int, default=3, help="runs of each route, in turns")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import PIL

    from tedm_tpu_torch import native
    from tedm_tpu_torch.data.datasets import CXR14Dataset

    with tempfile.TemporaryDirectory() as tmp:
        root = write_corpus(tmp, args.n, args.side, args.seed)
        ds = CXR14Dataset(os.path.join(root, "CXR14"), splits_dir=os.path.join(root, "data"))
        batches = [list(range(i, i + args.batch)) for i in range(0, args.n - args.batch + 1, args.batch)]
        size = (ds.img_size, ds.img_size)
        png = native.png_available()

        with ThreadPoolExecutor(max_workers=args.threads) as pool:
            routes = {
                "per_item_pool": ("1", lambda idx: np.stack(list(pool.map(ds.__getitem__, idx)))),
                "get_batch": ("1", lambda idx: ds.get_batch(idx, pool.map)),
                "batch_call_at_threads": ("1", lambda idx: native.load_resize_png_batch(
                    [ds._path(i) for i in idx], size, num_threads=args.threads)[0].astype(np.float32)[..., None]
                    / 255.0),
                "pil_pool": ("0", lambda idx: ds.get_batch(idx, pool.map)),
                "pil_serial": ("0", lambda idx: ds.get_batch(idx)),
            }
            if not png:
                for name in ("per_item_pool", "get_batch", "batch_call_at_threads"):
                    del routes[name]
            runs, ref = {name: [] for name in routes}, None
            for _ in range(args.repeats):
                for name, (env, read) in routes.items():
                    os.environ["TEDM_NATIVE"] = env
                    read(batches[0])  # warm: the files' pages and the library
                    t0 = time.perf_counter()
                    got = [read(idx) for idx in batches]
                    runs[name].append(1e3 * (time.perf_counter() - t0) / len(batches))
                    ref = ref or got
                    if not all(np.array_equal(a, b) for a, b in zip(got, ref)):
                        raise SystemExit(f"the {name} route's batches differ from the first route's")
            os.environ.pop("TEDM_NATIVE")

    report = {"flavor": native.flavor(), "pillow": PIL.__version__, "cpu_count": os.cpu_count(),
              "files": args.n, "side": args.side, "batch": args.batch, "threads": args.threads,
              "batches_a_run": len(batches), "ms_a_batch": runs,
              "median_ms": {k: statistics.median(v) for k, v in runs.items()}}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
