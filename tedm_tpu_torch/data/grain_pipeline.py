"""The grain-backed input pipeline (``--data_backend grain``; port of
``tedm_tpu/data/grain_pipeline.py``).

``pipeline.Loader``'s batch contract (static shapes, ``valid`` masks, the
epoch's shuffle a pure function of (seed, epoch), strided shards) on top of
``grain.MapDataset``, for deployments that want grain's worker threads and
checkpointable iterators. Any dataset of ``tedm_tpu_torch.data.datasets``
works (random-access ``__len__`` / ``__getitem__``):

    loader = GrainLoader(dataset, batch_size=16, shuffle=True, seed=0,
                         shard_index=mesh.data_rank(), shard_count=mesh.data_world())
    for batch in loader:          # {"image", ("mask",) "valid"}, NHWC numpy
        ...

Lockstep: every shard emits the same batch size and the same number of
batches an epoch, however unevenly the strided shard divides; a short shard
is padded with ``valid`` = 0 filler batches (or cut under ``drop_last``),
so that no rank enters a step's collectives that another skips. ``grain``
is imported where it is used; ``pipeline.build_dataloaders`` refuses the
backend, naming the package, where it is not installed.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np


class _Source:
    """grain RandomAccessDataSource over our dataset objects."""

    def __init__(self, dataset):
        self._ds = dataset

    def __len__(self) -> int:
        return len(self._ds)

    def __getitem__(self, i: int):
        return self._ds[int(i)]


class GrainLoader:
    """``pipeline.Loader``'s interface and batch contract, over grain."""

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
        num_workers: int = 0,
        subset: Optional[int] = None,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.has_labels = getattr(dataset, "has_labels", True)
        n = len(dataset) if subset is None else min(subset, len(dataset))
        self.indices = np.arange(n)  # Loader-contract attribute
        self._n = n
        self._shuffle = shuffle
        self._seed = seed
        self._shard = (shard_index, shard_count)
        self._num_workers = num_workers
        self.drop_last = drop_last
        self.epoch = 0

        # the shard-invariant batch size and batch count of pipeline.Loader
        max_shard = (n + shard_count - 1) // shard_count
        min_shard = n // shard_count
        self.batch_size = min(batch_size, max(1, max_shard))
        if drop_last:
            if min_shard == 0:
                raise ValueError(
                    f"drop_last=True with {n} items over {shard_count} shards "
                    "leaves some host with an empty shard: every epoch would "
                    "yield zero batches and repeat() would spin forever."
                )
            if min_shard < self.batch_size:
                print(
                    f"[grain_pipeline] drop_last: clamping batch_size "
                    f"{self.batch_size} -> {min_shard} (smallest host shard)"
                )
                self.batch_size = min_shard
            self._epoch_batches = min_shard // self.batch_size
        else:
            self._epoch_batches = (max_shard + self.batch_size - 1) // self.batch_size

    def _epoch_ds(self, epoch: int):
        """The epoch's shuffled view of this shard (the permutation a pure
        function of (seed, epoch), the same on every rank)."""
        import grain

        ds = grain.MapDataset.source(_Source(self.dataset))[: self._n]
        if self._shuffle:
            ds = ds.shuffle(seed=self._seed + epoch)
        i, c = self._shard
        return ds[i::c]

    def __len__(self) -> int:
        return self._epoch_batches

    def _item_shapes(self):
        it = self.dataset[0]
        if self.has_labels:
            return it[0].shape, it[1].shape
        return it.shape, None

    def _filler_batch(self) -> Dict[str, np.ndarray]:
        """All-padding batch (valid=0 rows) for lockstep on short shards."""
        bs = self.batch_size
        img_s, mask_s = self._item_shapes()
        out = {
            "image": np.zeros((bs, *img_s), np.float32),
            "valid": np.zeros((bs,), np.float32),
        }
        if mask_s is not None:
            out["mask"] = np.zeros((bs, *mask_s), np.float32)
        return out

    def _to_batch(self, items) -> Dict[str, np.ndarray]:
        bs = self.batch_size
        valid = np.zeros((bs,), np.float32)
        valid[: len(items)] = 1.0

        def pad(x):
            if len(x) < bs:
                x = np.concatenate(
                    [x, np.zeros((bs - len(x), *x.shape[1:]), x.dtype)]
                )
            return x

        if self.has_labels:
            imgs = pad(np.stack([it[0] for it in items]))
            masks = pad(np.stack([it[1] for it in items]))
            return {"image": imgs, "mask": masks, "valid": valid}
        return {"image": pad(np.stack(items)), "valid": valid}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        import grain

        ds = self._epoch_ds(self.epoch)
        self.epoch += 1
        read_opts = grain.ReadOptions(
            num_threads=max(1, self._num_workers), prefetch_buffer_size=64
        )
        it = iter(ds.to_iter_dataset(read_options=read_opts))
        emitted = 0
        buf = []
        for item in it:
            buf.append(item)
            if len(buf) == self.batch_size:
                if emitted == self._epoch_batches:  # truncate (lockstep)
                    buf = []
                    break
                yield self._to_batch(buf)
                emitted += 1
                buf = []
        if buf and not self.drop_last and emitted < self._epoch_batches:
            yield self._to_batch(buf)
            emitted += 1
        # valid = 0 filler, so that every shard emits _epoch_batches batches
        while emitted < self._epoch_batches:
            yield self._filler_batch()
            emitted += 1

    def repeat(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield from self
