"""Synthetic CXR images rendered on the device (``--data_backend device``;
port of ``tedm_tpu/data/device_synthetic.py``).

The host computes index batches only; each batch's images are rendered on
the device the loader is given, as NCHW float32 tensors that the trainers
use as they are. The batch contract is ``pipeline.Loader``'s: static shapes,
a ``valid`` mask (numpy, on the host), the epoch permutation
``RandomState(seed + epoch)``, strided shards and a batch count that every
shard shares, padding rows rendered from index 0.

The JAX generator (``make_generator``) is split here into its random draws
and a pure ``render(draws)``: per lung the centre's normal offsets, the
radii's and the darkening's uniforms and the tilt's normal, the rib
frequency's uniform, and an S x S speckle field. ``render`` is JAX's
arithmetic, operation for operation, so that JAX's own draws give JAX's
images. The port draws from a generator on the device seeded by (split,
seed, index) alone (``index_seed``), so an image is a pure function of
them whatever batch or shard it falls in, on one kind of device; the
pixels are not JAX's, whose generator is threefry's.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

N_SCALARS = 13  # 6 a lung, then the rib frequency


def base_seed(split: str, seed: int) -> int:
    """JAX's per-split seed: crc32, stable across processes."""
    return zlib.crc32(f"{split}:{seed}".encode()) % (2**31 - 1)


def index_seed(base: int, index: int) -> int:
    """The device generator's seed of image ``index``: distinct for every
    (split seed, index)."""
    return (base << 32) | int(index)


def draws(base: int, idx: np.ndarray, img_size: int, device: Union[str, torch.device]) -> Dict[str, torch.Tensor]:
    """The random draws of images ``idx`` on ``device``: ``lungs`` (B, 2, 6)
    [cx, cy normals, rx, ry uniforms, theta normal, darkening uniform] of
    the left then the right lung, ``rib`` (B,) uniform, ``speckle`` (B, S,
    S) normal. Each image's come from one normal vector of its own
    generator; a uniform is its normal's CDF."""
    n = N_SCALARS + img_size * img_size
    z = torch.empty((len(idx), n), device=device)
    gen = torch.Generator(device=device)
    for row, i in enumerate(idx):
        gen.manual_seed(index_seed(base, i))
        torch.randn(n, generator=gen, device=device, out=z[row])
    scalars = z[:, :N_SCALARS]
    uniform = 0.5 * (1.0 + torch.erf(scalars / math.sqrt(2.0)))
    is_uniform = torch.tensor([0, 0, 1, 1, 0, 1] * 2 + [1], dtype=torch.bool, device=device)
    scalars = torch.where(is_uniform, uniform, scalars)
    return {"lungs": scalars[:, :12].reshape(-1, 2, 6), "rib": scalars[:, 12],
            "speckle": z[:, N_SCALARS:].reshape(-1, img_size, img_size)}


def render(d: Dict[str, torch.Tensor], labelled: bool = True):
    """JAX's image of the draws ``d`` (``draws``' layout), NCHW: (img (B, 1,
    S, S) in [0, 1], mask (B, 1, S, S) binary, or None unless
    ``labelled``), float32 on the draws' device
    (tedm_tpu/data/device_synthetic.py:34-75)."""
    speckle = d["speckle"]
    s, dev = speckle.shape[-1], speckle.device
    grid = torch.arange(s, dtype=torch.float32, device=dev) / s
    yy, xx = grid[:, None], grid[None, :]
    body = 0.25 + 0.35 * torch.exp(-(((yy - 0.5) ** 2) / 0.5 + ((xx - 0.5) ** 2) / 0.25))
    img = body.expand(speckle.shape)
    mask = torch.zeros_like(speckle)
    col = lambda v: v[:, None, None]
    for i, side in enumerate((-1.0, 1.0)):
        cxn, cyn, rxu, ryu, thn, dark = d["lungs"][:, i].unbind(1)
        cx = 0.5 + side * (0.21 + 0.03 * col(cxn))
        cy = 0.48 + 0.03 * col(cyn)
        rx = 0.13 + 0.02 * col(rxu)
        ry = 0.26 + 0.03 * col(ryu)
        theta = 0.12 * side + 0.05 * col(thn)
        xr = (xx - cx) * torch.cos(theta) - (yy - cy) * torch.sin(theta)
        yr = (xx - cx) * torch.sin(theta) + (yy - cy) * torch.cos(theta)
        lung = ((xr / rx) ** 2 + (yr / ry) ** 2) < 1.0
        mask = torch.maximum(mask, lung.float())
        img = torch.where(lung, img - 0.18 - 0.04 * col(dark), img)
    img = img + 0.03 * torch.sin(yy * (40 + 5 * col(d["rib"])) + xx * 3)
    img = img + 0.02 * speckle
    img = torch.clip(img, 0.0, 1.0)[:, None]
    return img, (mask[:, None] if labelled else None)


class DeviceSyntheticLoader:
    """``pipeline.Loader``'s interface and batch contract; batches hold
    ``image`` (and ``mask``) as NCHW tensors on ``device`` and ``valid`` as
    numpy."""

    def __init__(
        self,
        split: str,
        n: int,
        img_size: int,
        batch_size: int,
        labelled: bool = True,
        seed: int = 0,
        shuffle: bool = False,
        drop_last: bool = False,
        shard_index: int = 0,
        shard_count: int = 1,
        subset: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.split = split
        self.img_size = img_size
        self.has_labels = labelled
        n = n if subset is None else min(subset, n)
        self.indices = np.arange(n)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard_index = shard_index
        self.shard_count = shard_count
        self.device = torch.device(device)
        self.epoch = 0
        self._base = base_seed(split, seed)

        # the lockstep arithmetic of pipeline.Loader
        max_shard = (n + shard_count - 1) // shard_count
        min_shard = n // shard_count
        self.batch_size = min(batch_size, max(1, max_shard))
        if drop_last:
            if min_shard == 0:
                raise ValueError(
                    f"drop_last=True with {n} items over {shard_count} shards "
                    "leaves some host with an empty shard."
                )
            self.batch_size = min(self.batch_size, min_shard)
            self._epoch_batches = min_shard // self.batch_size
        else:
            self._epoch_batches = (max_shard + self.batch_size - 1) // self.batch_size

    def __len__(self) -> int:
        return self._epoch_batches

    def _shard_indices(self, epoch: int) -> np.ndarray:
        idx = self.indices
        if self.shuffle:
            idx = np.random.RandomState(self.seed + epoch).permutation(idx)
        return idx[self.shard_index :: self.shard_count]

    def index_batches(self):
        """The next epoch's batches of indices, each padded with index 0 to
        the batch size, and their ``valid`` masks."""
        idx = self._shard_indices(self.epoch)
        self.epoch += 1
        bs = self.batch_size
        batches = [idx[i : i + bs] for i in range(0, len(idx), bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == bs]
        batches = batches[: self._epoch_batches]
        while len(batches) < self._epoch_batches:
            batches.append(np.array([], dtype=np.int64))
        for b in batches:
            valid = np.zeros((bs,), np.float32)
            valid[: len(b)] = 1.0
            pad = np.zeros((bs,), np.int64)
            pad[: len(b)] = b
            yield pad, valid

    def __iter__(self) -> Iterator[Dict[str, object]]:
        for pad, valid in self.index_batches():
            img, mask = render(draws(self._base, pad, self.img_size, self.device), self.has_labels)
            out = {"image": img, "valid": valid}
            if self.has_labels:
                out["mask"] = mask
            yield out

    def repeat(self) -> Iterator[Dict[str, object]]:
        while True:
            yield from self
