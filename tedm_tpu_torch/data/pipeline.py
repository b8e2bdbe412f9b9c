"""Batch loader: static shapes, seeded shuffling, prefetch, host sharding
(port of ``Loader`` and ``build_dataloaders`` in ``tedm_tpu/data/pipeline.py``).
``build_dataloaders``' ``backend`` picks the loader: ``threads`` (``Loader``),
``grain`` (``grain_pipeline.GrainLoader``) or ``device``
(``device_synthetic.DeviceSyntheticLoader``, synthetic data only, rendered
on the device as NCHW tensors).

* Every batch has the same shape and carries a ``valid`` mask (1.0 for real
  rows, 0.0 for padding); losses and metrics are mask-aware.
* The epoch permutation is ``RandomState(seed + epoch)``, the same on every
  process, so the strided shards of a data-parallel run never overlap
  (``shard_index``/``shard_count``).
* Samples are made in ``num_workers`` threads while the device computes; a
  bounded queue holds ready batches. A dataset without labels that has
  ``get_batch`` (CXR14) makes each batch in one call instead.

Batches are NHWC numpy, as in the JAX package; the trainers move them to
the device as NCHW tensors.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
import importlib.util
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np


class Loader:
    PREFETCH = 2  # ready batches the producer may hold

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
        num_workers: int = 4,
        subset: Optional[int] = None,
    ):
        self.dataset = dataset
        self.has_labels = getattr(dataset, "has_labels", True)
        n = len(dataset) if subset is None else min(subset, len(dataset))
        self.indices = np.arange(n)  # a subset is the first n rows
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.num_workers = max(1, num_workers)
        self.epoch = 0

        # shard-invariant batch size and batch count per epoch, so that
        # every process of a data-parallel run steps in lockstep
        max_shard = (n + shard_count - 1) // shard_count
        min_shard = n // shard_count
        self.batch_size = min(batch_size, max(1, max_shard))
        if drop_last:
            if min_shard == 0:
                raise ValueError(
                    f"drop_last=True with {n} items over {shard_count} shards "
                    "leaves some process with an empty shard: every epoch would "
                    "yield zero batches and repeat() would spin forever."
                )
            if min_shard < self.batch_size:
                print(
                    f"[pipeline] drop_last: clamping batch_size "
                    f"{self.batch_size} -> {min_shard} (smallest shard)"
                )
                self.batch_size = min_shard
            self._epoch_batches = min_shard // self.batch_size
        else:
            self._epoch_batches = (max_shard + self.batch_size - 1) // self.batch_size

    def _shard_indices(self, epoch: int) -> np.ndarray:
        idx = self.indices
        if self.shuffle:
            idx = np.random.RandomState(self.seed + epoch).permutation(idx)
        return idx[self.shard_index :: self.shard_count]

    def __len__(self) -> int:
        return self._epoch_batches

    def _make_batch(self, idxs: np.ndarray, pool: ThreadPoolExecutor) -> Dict[str, np.ndarray]:
        bs = self.batch_size
        valid = np.zeros((bs,), np.float32)
        valid[: len(idxs)] = 1.0
        if len(idxs) and not self.has_labels and hasattr(self.dataset, "get_batch"):
            # one call for the whole batch (CXR14: one native decode and
            # resize across C++ threads, without the GIL; PIL in the pool)
            items = list(self.dataset.get_batch(list(idxs), pool.map))
        else:
            items = list(pool.map(self.dataset.__getitem__, idxs))
        # a shard that ran out before the epoch's batch count yields a batch
        # of padding only, shaped like item 0
        first = items[0] if items else self.dataset[0]
        fields = list(zip(*items)) if self.has_labels else [items]
        out = []
        for f, like in enumerate(first if self.has_labels else (first,)):
            arr = np.zeros((bs, *like.shape), np.float32)
            if items:
                arr[: len(items)] = np.stack(fields[f])
            out.append(arr)
        batch = {"image": out[0], "valid": valid}
        if self.has_labels:
            batch["mask"] = out[1]
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._shard_indices(self.epoch)
        self.epoch += 1
        batches = [idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        batches = batches[: self._epoch_batches]
        while len(batches) < self._epoch_batches:
            batches.append(np.array([], dtype=np.int64))

        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()
        DONE, ERROR = "__done__", "__error__"

        def _put(item) -> bool:
            """A bounded put that gives up once the consumer has gone (a
            ``break`` in the consumer must not leave the producer blocked)."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in batches:
                        if not _put((None, self._make_batch(b, pool))):
                            return
                _put((DONE, None))
            except BaseException as e:  # hand dataset errors to the consumer
                _put((ERROR, e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == DONE:
                    break
                if kind == ERROR:
                    raise item
                yield item
        finally:
            stop.set()

    def repeat(self) -> Iterator[Dict[str, np.ndarray]]:
        """An endless stream of epochs (the reference's outer epoch loop,
        trainers/train_baseline.py:24-96)."""
        while True:
            yield from self


def build_dataloaders(
    dataset: str,
    data_dir: Optional[str],
    img_size: int = 128,
    batch_size: int = 16,
    num_workers: int = 4,
    n_labelled_images: Optional[int] = None,
    seed: int = 0,
    shard_index: int = 0,
    shard_count: int = 1,
    synthetic: bool = False,
    splits_dir: Optional[str] = None,
    drop_last: bool = False,
    backend: str = "threads",
    device: Union[str, Any] = "cuda",
) -> Dict[str, Loader]:
    """Train, val and test loaders of ``dataset`` (JSRT or CXR14), read from
    ``data_dir`` with the split CSVs of ``splits_dir`` (the port's copies by
    default), or from the synthetic corpus with the same split sizes
    (``synthetic``, or no ``data_dir``). Train is shuffled and sharded; val
    and test are neither. The JSRT train subset is its first
    ``n_labelled_images`` rows (reference: dataloaders/JSRT.py:29-31).
    ``drop_last`` drops every loader's last partial batch instead of padding
    it (the contrastive trainers: a padding row must not reach their losses).
    ``backend`` as the module docstring says; ``device`` is where the
    ``device`` backend renders (tedm_tpu/data/pipeline.py:224-260)."""
    from tedm_tpu_torch.data.datasets import (
        SPLITS_DIR,
        CXR14Dataset,
        JSRTDataset,
        SyntheticCXRDataset,
    )

    synthetic = synthetic or data_dir is None
    sdir = splits_dir or SPLITS_DIR
    if backend not in ("threads", "grain", "device"):
        raise ValueError(f"unknown data backend {backend!r}")
    if backend == "grain" and importlib.util.find_spec("grain") is None:
        raise ModuleNotFoundError("--data_backend grain needs the 'grain' package, which is not installed here")

    if backend == "device":
        # synthetic images rendered on the device; the host ships index batches
        if not synthetic:
            raise ValueError("backend='device' requires synthetic data")
        from tedm_tpu_torch.data.device_synthetic import DeviceSyntheticLoader

        def mkd(split, n, labelled, shuffle, shard, subset=None):
            return DeviceSyntheticLoader(
                split, n, img_size, batch_size, labelled=labelled, seed=seed, shuffle=shuffle,
                shard_index=shard_index if shard else 0, shard_count=shard_count if shard else 1,
                subset=subset, drop_last=drop_last, device=device,
            )

        if dataset == "JSRT":
            return {"train": mkd("train", 197, True, True, True, n_labelled_images),
                    "val": mkd("val", 25, True, False, False), "test": mkd("test", 25, True, False, False)}
        if dataset == "CXR14":
            return {"train": mkd("cxr_train", 2048, False, True, True),
                    "val": mkd("cxr_train", 2048, False, False, False),
                    "test": mkd("cxr_train", 2048, False, False, False)}
        raise ValueError(f"unknown dataset {dataset}")

    def mk(ds, shuffle, shard, subset=None):
        kw = dict(shuffle=shuffle, seed=seed, drop_last=drop_last, shard_index=shard_index if shard else 0,
                  shard_count=shard_count if shard else 1, subset=subset)
        if backend == "grain":
            from tedm_tpu_torch.data.grain_pipeline import GrainLoader

            return GrainLoader(ds, batch_size, **kw)
        return Loader(ds, batch_size, num_workers=num_workers, **kw)

    if dataset == "JSRT":
        if synthetic:
            splits = {name: SyntheticCXRDataset(name, n, img_size, labelled=True, seed=seed)
                      for name, n in (("train", 197), ("val", 25), ("test", 25))}
        else:
            splits = {name: JSRTDataset(data_dir, f"JSRT_{name}_split.csv", img_size, splits_dir=sdir)
                      for name in ("train", "val", "test")}
        return {
            "train": mk(splits["train"], True, True, subset=n_labelled_images),
            "val": mk(splits["val"], False, False),
            "test": mk(splits["test"], False, False),
        }
    if dataset == "CXR14":
        # the reference's val and test read train_split.csv too
        # (dataloaders/CXR14.py:30-32)
        if synthetic:
            train = val = SyntheticCXRDataset("cxr_train", 2048, img_size, labelled=False, seed=seed)
        else:
            train = CXR14Dataset(data_dir, "train_split.csv", img_size, splits_dir=sdir)
            val = CXR14Dataset(data_dir, "train_split.csv", img_size, splits_dir=sdir)
        return {"train": mk(train, True, True), "val": mk(val, False, False), "test": mk(val, False, False)}
    raise ValueError(f"unknown dataset {dataset}")
