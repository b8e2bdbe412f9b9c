"""Segmentation serving (port of ``tedm_tpu/serve/app.py``).

``Predictor`` serves the Baseline, Global CL, Global & Local CL, LEDM,
LEDMe, TEDM and PDDM models from ``<logs_root>/<folder>/<size>/best``
checkpoints (the folders of ``MODEL_FOLDERS``; PDDM is the port's
addition), restored by the eval harness's ``load_experiment`` (the two
contrastive finetunes as baseline UNets): load a CXR, predict the lung
mask, optionally post-process (keep the two largest connected components
and draw their boundary, reference app.py:97-110), and tile the results
into one labelled grid (``predict``, reference app.py:114-148). Images go in
and masks come out as NHWC numpy, as in the JAX package. The gradio UI
(``launch``, ``python -m tedm_tpu_torch.serve.app``) needs gradio and
refuses without it; ``predict`` and ``Predictor`` work headless.

Models are cached after their first load. On the card ``Predictor`` also
keeps one CUDA graph per (checkpoint, input shape), the port's form of the
``jax.jit`` cache of JAX's ``Predictor._load``: the first request of a shape
runs eager on a side stream (it builds the kernels, B.4's and B.2's weight
layouts, B.1's arrival counters for that stream and cuDNN's choices), then
the request is captured on that stream; every later request copies its
image (and noise) into the graph's static inputs and replays it. The
NOISE_SEED draw is the same on every request, so it is drawn once into the
static noise buffer; caller noise is copied into that buffer. All graphs
share one memory pool: requests replay one after another on one stream,
and each graph's output is read before the next replay. A replay moves no
host launch counter (``chip_smoke.py`` counts its launches from the
profiler). On the CPU ``Predictor`` stays eager.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

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
# the grid's rows: JAX's six models in its order, then PDDM, so that a grid of
# the six is JAX's
MODEL_ORDER = list(MODEL_FOLDERS)

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


def eager_sigmoids(task, x: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
    """The sigmoids of every folded row of one request, run eagerly: how the
    CPU serves every request (noise from a generator seeded with NOISE_SEED
    unless the caller gave noise)."""
    gen = None if noise is not None else torch.Generator(device=x.device).manual_seed(NOISE_SEED)
    with torch.inference_mode():
        return torch.sigmoid(task.apply(x, generator=gen, noise=noise).float())


class _GraphedRequest:
    """One request of one model at one input shape as a CUDA graph: the
    eager warm-up and the capture on ``stream``, then replays. ``noise``
    holds the q_sample noise of every folded row (the NOISE_SEED draw
    unless a caller gave noise)."""

    def __init__(self, task, x: torch.Tensor, noise: Optional[torch.Tensor], stream, pool):
        dev = x.device
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), torch.inference_mode():
            self.x = x.clone()
            self.default_noise = self.noise = None
            if task.t_steps:  # the draw of task.apply from a generator seeded with NOISE_SEED
                gen = torch.Generator(device=dev).manual_seed(NOISE_SEED)
                rows = (len(task.t_steps) * x.shape[0], *x.shape[1:])
                self.default_noise = torch.randn(rows, generator=gen, device=dev)
                self.noise = torch.empty_like(self.default_noise)
            self._set_noise(noise)
            self.first = self._run(task)  # the warm-up, the first request's result
        self.graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(self.graph, pool=pool, stream=stream):
            self.out = self._run(task)
        torch.cuda.current_stream(dev).wait_stream(stream)

    def _run(self, task) -> torch.Tensor:
        return torch.sigmoid(task.apply(self.x, noise=self.noise).float())

    def _set_noise(self, noise: Optional[torch.Tensor]) -> None:
        if self.noise is not None:
            src = self.default_noise if noise is None else noise
            self.noise.copy_(src if src.shape[0] == self.noise.shape[0] else src.repeat(
                self.noise.shape[0] // src.shape[0], 1, 1, 1))

    def replay(self, x: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            self.x.copy_(x)
            self._set_noise(noise)
            self.graph.replay()
        return self.out


class Predictor:
    """Checkpoint-cached predictor on one device (``cuda`` by default); on
    the card each (checkpoint, input shape) is replayed as a CUDA graph from
    its second request on, on the CPU every request runs eagerly (module
    docstring)."""

    def __init__(self, logs_root: str = "logs", device: Union[str, torch.device] = "cuda"):
        self.logs_root = logs_root
        self.device = resolve_device(device)
        self._cache: Dict[str, Tuple[Config, Any]] = {}
        self._graphs: Dict[Tuple[str, Tuple[int, ...]], _GraphedRequest] = {}
        cuda = self.device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self._stream = torch.cuda.Stream(self.device) if cuda else None

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

    def _sigmoids(self, ckpt_dir: str, task, x: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
        """The sigmoids of every folded row, (fold*B, C, H, W): eager, or the
        first request of a graph, or its replay."""
        if self._stream is None:
            return eager_sigmoids(task, x, noise)
        key = (ckpt_dir, tuple(x.shape))
        graphed = self._graphs.get(key)
        if graphed is None:
            graphed = self._graphs[key] = _GraphedRequest(task, x, noise, self._stream, self._pool)
            return graphed.first
        return graphed.replay(x, noise)

    def _probabilities(
        self, img: np.ndarray, model: str, training_size: int, noise: Optional[np.ndarray] = None,
        mean: bool = True,
    ) -> np.ndarray:
        """Sigmoid probabilities (B, H, W, C), averaged over the timesteps of
        a folded head (reference app.py:79), or without ``mean`` every folded
        row, (fold*B, H, W, C), step-major. ``noise`` (B, H, W, C), when
        given, is used at every timestep; else noise comes from a generator
        seeded with NOISE_SEED."""
        ckpt_dir = self._experiment_dir(model, training_size)
        config, task = self._load(ckpt_dir)
        if img.shape[1] != config.img_size:
            # serve any input size against any checkpoint resolution
            img = load_img(img[0, :, :, 0], config.img_size)
        x = to_nchw(img, self.device)
        if noise is not None:
            noise = to_nchw(noise, self.device)
        probs = self._sigmoids(ckpt_dir, task, x, noise)
        with torch.inference_mode():
            if mean:
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


def _put_text(img: np.ndarray, text: str, color) -> np.ndarray:
    """Label a tile bottom-left with PIL (cv2.putText stand-in)."""
    from PIL import Image, ImageDraw

    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    pil = Image.fromarray(arr if arr.ndim == 3 else np.stack([arr] * 3, -1))
    ImageDraw.Draw(pil).text(
        (5, img.shape[0] - 12), text, fill=tuple(int(c * 255) for c in color)
    )
    return np.asarray(pil, np.float32) / 255.0


def predict(
    img_file,
    models: Sequence[str],
    training_sizes: Sequence[int],
    seg_img: bool = False,
    predictor: Optional[Predictor] = None,
    progress=None,
) -> np.ndarray:
    """Grid composer (reference: app.py:114-148): rows = models in
    ``MODEL_ORDER``, columns = sorted training sizes."""
    predictor = predictor or Predictor()
    img = load_img(img_file)
    models = sorted(models, key=MODEL_ORDER.index)
    rows = []
    for model in models:
        tiles = []
        for size in sorted(training_sizes):
            out = predictor.predict(img, model, size)
            color = (0.5, 0.5, 0.5)
            if seg_img:
                base = img[0, :, :, 0]
                if base.shape != out.shape:
                    base = load_img(base, out.shape[0])[0, :, :, 0]
                out = postprocess(out, base)
                color = (1.0, 1.0, 1.0)
            tiles.append(_put_text(out, f"{model} {size}", color))
        rows.append(np.concatenate(tiles, axis=1))
    grid = np.concatenate(rows, axis=0)
    if grid.shape[1] <= IMG_SIZE * 2:
        pad = (330 - grid.shape[1]) // 2
        widths = ((0, 0), (pad, pad)) + (((0, 0),) if grid.ndim == 3 else ())
        grid = np.pad(grid, widths, constant_values=1)
    return grid


ABSTRACT = (
    "Medical image segmentation is a challenging task, made more difficult by "
    "many datasets' limited size and annotations. This demo serves the TEDM "
    "family of semi-supervised diffusion-feature segmentation models "
    "(baseline / contrastive / LEDM / LEDMe / TEDM) across training sizes."
)


def write_example_images(out_dir: str, n: int = 12, img_size: int = IMG_SIZE) -> List[str]:
    """Synthetic example CXR PNGs for the demo (the reference ships 12 NIH
    examples, app.py:168-181; those images are licensed, so the demo
    generates stand-ins)."""
    from PIL import Image

    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset

    os.makedirs(out_dir, exist_ok=True)
    ds = SyntheticCXRDataset("demo", n, img_size, labelled=False)
    paths = []
    for i in range(n):
        arr = (ds[i][:, :, 0] * 255).astype(np.uint8)
        p = os.path.join(out_dir, f"example_{i:02d}.png")
        Image.fromarray(arr).save(p)
        paths.append(p)
    return paths


def launch(logs_root: str = "logs", share: bool = False, device: Union[str, torch.device] = "cuda"):
    """Gradio UI (reference: app.py:155-191). Requires gradio."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed in this environment; use "
            "tedm_tpu_torch.serve.app.predict(...) for headless serving"
        ) from e
    import tempfile

    examples = write_example_images(os.path.join(tempfile.gettempdir(), "tedm_tpu_torch_examples"))
    predictor = Predictor(logs_root, device=device)

    def fn(img, models, sizes, seg):
        return predict(img, models, [int(s) for s in sizes], seg, predictor)

    demo = gr.Interface(
        fn=fn,
        inputs=[
            gr.Image(label="Chest X-ray", type="pil"),
            gr.CheckboxGroup(MODEL_ORDER, label="Model",
                             value=["Baseline", "LEDM", "LEDMe", "TEDM"]),
            gr.CheckboxGroup([1, 3, 6, 12, 197], label="Training size",
                             value=[1, 3, 6, 12, 197]),
            gr.Checkbox(label="Show masked image (otherwise show binary "
                              "segmentation)", value=True),
        ],
        outputs=gr.Image(label="Segmentation"),
        examples=[[p] for p in examples],
        title="Chest X-ray Segmentation with TEDM (H100)",
        description=ABSTRACT,
        cache_examples=False,
    )
    demo.queue().launch(share=share)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--logs", type=str, default="logs")
    p.add_argument("--share", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    launch(args.logs, args.share, args.device)


if __name__ == "__main__":
    main()
