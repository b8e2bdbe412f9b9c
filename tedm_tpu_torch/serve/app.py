"""Headless segmentation serving (port of ``tedm_tpu/serve/app.py``).

``Predictor`` serves the Baseline, Global CL, Global & Local CL, LEDM,
LEDMe, TEDM and PDDM models from ``<logs_root>/<folder>/<size>/best``
checkpoints (the folders of ``MODEL_FOLDERS``; PDDM is the port's
addition), restored by the eval harness's ``load_experiment`` (the two
contrastive finetunes as baseline UNets): load a CXR, predict the lung
mask, optionally post-process (keep the two largest connected components
and draw their boundary, reference app.py:97-110). Models are cached after
their first load. Images go in and masks come out as NHWC numpy, as in the
JAX package. The gradio UI, the grid composer and export are ROADMAP item
A.5f.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.eval.harness import load_experiment
from tedm_tpu_torch.trainers.common import to_nchw
from tedm_tpu_torch.utils.device import resolve_device

IMG_SIZE = 128

MODEL_FOLDERS = {
    "Baseline": "baseline",
    "Global CL": "global_finetune",
    "Global & Local CL": "glob_loc_finetune",
    "LEDM": "LEDM",
    "LEDMe": "LEDMe",
    "TEDM": "TEDM",
    "PDDM": "PDDM",
}

# the JAX predictor draws its noise from PRNGKey(0) on every request; the
# port draws it from a generator seeded with this on every request
NOISE_SEED = 0


def load_img(img_file, img_size: int = IMG_SIZE) -> np.ndarray:
    """numpy / PIL / path -> (1, H, W, 1) float32 in [0, 1]
    (reference: app.py:20-43)."""
    from PIL import Image

    if isinstance(img_file, np.ndarray):
        img = img_file.astype(np.float32)
        if img.max() > 1:
            img = img / 255.0
        if img.ndim == 3:
            img = img.mean(axis=-1)
        img = np.asarray(
            Image.fromarray((img * 255).astype(np.uint8)).resize((img_size, img_size)),
            np.float32,
        ) / 255.0
    elif isinstance(img_file, str):
        img = np.asarray(
            Image.open(img_file).convert("L").resize((img_size, img_size)), np.float32
        ) / 255.0
    else:
        try:
            img = np.asarray(
                img_file.convert("L").resize((img_size, img_size)), np.float32
            ) / 255.0
        except AttributeError:
            raise TypeError("Input must be a numpy array, PIL image, or filepath")
    return img[None, :, :, None]


class Predictor:
    """Checkpoint-cached predictor on one device (``cuda`` by default)."""

    def __init__(self, logs_root: str = "logs", device: Union[str, torch.device] = "cuda"):
        self.logs_root = logs_root
        self.device = resolve_device(device)
        self._cache: Dict[str, Tuple[Config, Any]] = {}

    def _load(self, ckpt_dir: str) -> Tuple[Config, Any]:
        if ckpt_dir not in self._cache:
            self._cache[ckpt_dir] = load_experiment(ckpt_dir, self.device)
        return self._cache[ckpt_dir]

    def _experiment_dir(self, model: str, training_size: int) -> str:
        ckpt_dir = os.path.join(self.logs_root, MODEL_FOLDERS[model], str(training_size))
        # accept either the run dir itself or a timestamped subdir
        if not os.path.isdir(os.path.join(ckpt_dir, "best")):
            subs = sorted(os.listdir(ckpt_dir), reverse=True) if os.path.isdir(ckpt_dir) else []
            for s in subs:
                if os.path.isdir(os.path.join(ckpt_dir, s, "best")):
                    return os.path.join(ckpt_dir, s)
        return ckpt_dir

    def _probabilities(
        self, img: np.ndarray, model: str, training_size: int, noise: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Sigmoid probabilities (B, H, W, C), averaged over the timesteps of
        a folded head (reference app.py:79). ``noise`` (B, H, W, C), when
        given, is used at every timestep; else noise comes from a generator
        seeded with NOISE_SEED."""
        config, task = self._load(self._experiment_dir(model, training_size))
        if img.shape[1] != config.img_size:
            # serve any input size against any checkpoint resolution
            img = load_img(img[0, :, :, 0], config.img_size)
        x = to_nchw(img, self.device)
        gen = None
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(NOISE_SEED)
        else:
            noise = to_nchw(noise, self.device)
        with torch.inference_mode():
            probs = torch.sigmoid(task.apply(x, generator=gen, noise=noise).float())
            probs = probs.reshape(task.fold, -1, *probs.shape[1:]).mean(dim=0)
        return probs.permute(0, 2, 3, 1).cpu().numpy()

    def predict(self, img: np.ndarray, model: str, training_size: int) -> np.ndarray:
        """Binary (H, W) mask for one model family and training size
        (reference predict_* fns, app.py:45-79). ``img`` is (1, H, W, 1)."""
        probs = self._probabilities(img, model, training_size)
        return (probs[0, :, :, 0] > 0.5).astype(np.float32)


def postprocess(pred: np.ndarray, img: np.ndarray) -> np.ndarray:
    """Keep the two largest connected components and mark their outer
    boundaries in red on the image (reference: app.py:97-110)."""
    from scipy import ndimage

    labels, n = ndimage.label(pred)
    if n >= 2:
        sizes = ndimage.sum_labels(np.ones_like(labels), labels, range(1, n + 1))
        keep = np.argsort(sizes)[-2:] + 1
        mask = np.isin(labels, keep)
    else:
        mask = labels > 0
    rgb = np.stack([img, img, img], axis=-1)
    if mask.any():
        outer = ndimage.binary_dilation(mask) & ~mask
        rgb[outer] = (1.0, 0.0, 0.0)
    return rgb
