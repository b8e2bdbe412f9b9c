"""Experiment logging: scalars and image grids (port of
``tedm_tpu/utils/logging.py``).

The reference's ``TensorboardLogger`` (trainers/utils.py:101-151)
dispatches on value type and is off under ``--debug``. This logger keeps
that interface, always writes ``metrics.jsonl`` and a PNG per image grid,
and writes TensorBoard events too when ``tensorboard`` is installed.
Images are NHWC numpy in [0, 1], as in the JAX package.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np


def tile_grid(imgs: np.ndarray, ncols: Optional[int] = None, pad: int = 2) -> np.ndarray:
    """(N, H, W, C) -> one (H', W', C) grid image (make_grid equivalent,
    reference: trainers/utils.py:145-148)."""
    n, h, w, c = imgs.shape
    ncols = ncols or int(np.ceil(np.sqrt(n)))
    nrows = int(np.ceil(n / ncols))
    grid = np.zeros((nrows * (h + pad) + pad, ncols * (w + pad) + pad, c), imgs.dtype)
    for i in range(n):
        r, col = divmod(i, ncols)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y : y + h, x : x + w] = imgs[i]
    return grid


class MetricsLogger:
    """Scalar and image logging. ``log({name: value}, step)`` dispatches on
    shape like the reference logger (trainers/utils.py:133-151). In a
    data-parallel run rank 0 logs, the others' loggers are off."""

    def __init__(self, log_dir: str, config: Any = None, enabled: bool = True):
        from tedm_tpu_torch.parallel import mesh

        self.log_dir = log_dir
        self.enabled = enabled and mesh.rank() == 0
        self._tb = None
        self._jsonl = None
        if not self.enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is optional
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(log_dir)
        if config is not None and hasattr(config, "to_json"):
            with open(os.path.join(log_dir, "config.txt"), "w") as f:
                f.write(config.to_json())

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if not self.enabled:
            return
        scalars = {}
        for name, value in metrics.items():
            value = np.asarray(value)
            if value.ndim == 0:
                scalars[name] = float(value)
                if self._tb:
                    self._tb.add_scalar(name, float(value), step)
            elif value.ndim in (3, 4):
                self.log_images(name, value, step)
            else:
                scalars[name] = value.tolist()
        if scalars and self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")
            self._jsonl.flush()

    def log_images(self, name: str, imgs: np.ndarray, step: int) -> None:
        """imgs: (H, W, C) or (N, H, W, C) in [0, 1]; written as
        ``images/<name>_<step>.png``."""
        if not self.enabled:
            return
        from PIL import Image

        imgs = np.asarray(imgs, dtype=np.float32)
        if imgs.ndim == 3:
            imgs = imgs[None]
        grid = tile_grid(np.clip(imgs, 0.0, 1.0))
        if self._tb:
            self._tb.add_image(name, grid.transpose(2, 0, 1), step)
        arr = (grid * 255).astype(np.uint8)
        arr = arr[..., 0] if arr.shape[-1] == 1 else arr
        img_dir = os.path.join(self.log_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        Image.fromarray(arr).save(os.path.join(img_dir, f"{name.replace('/', '_')}_{step}.png"))

    def close(self) -> None:
        if self._tb:
            self._tb.close()
        if self._jsonl:
            self._jsonl.close()
