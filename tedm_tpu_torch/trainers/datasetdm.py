"""LEDM / LEDMe / TEDM: the frozen backbone and its feature classifier
(port of ``tedm_tpu/trainers/datasetdm.py``).

A frozen DDPM UNet provides decoder features at ``t_steps_to_save``; a
1x1-conv MLP head classifies each pixel. TEDM
(``shared_weights_over_timesteps``) folds the timesteps into the batch so
one head sees every timestep (reference: trainers/train_datasetDM.py:30-42);
its logits have ``fold`` = S times the batch, step-major. ``main`` trains
the head alone on the few labelled JSRT images (reference:
trainers/train_datasetDM.py): the features come under ``torch.no_grad`` and
only the head's parameters are in the optimizer (:46).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.pipeline import build_dataloaders
from tedm_tpu_torch.models.segmentation import PixelClassifier, extract_features
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.ops.schedules import DiffusionSchedule, make_schedule
from tedm_tpu_torch.trainers.common import compute_dtype, init_seeded, train_segmentation, unet_kernels
from tedm_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, load_config
from tedm_tpu_torch.utils.device import resolve_device
from tedm_tpu_torch.utils.logging import MetricsLogger


def load_backbone(
    config: Config, device: Union[str, torch.device] = "cuda"
) -> Tuple[Unet, DiffusionSchedule]:
    """The frozen diffusion backbone (reference: models/datasetDM_model.py:31-44)
    in eval mode on ``device``, with its schedule: restored from
    ``config.saved_diffusion_model`` when a checkpoint is there (its EMA
    weights when present, unless ``serve_raw_params``), else initialised from
    ``config.seed`` with a warning. The compute dtype and the opt-in kernels
    are ``config``'s, the head's, as in JAX (tedm_tpu/trainers/datasetdm.py:43-57):
    an fp32 checkpoint serves a bf16 head."""
    dev = resolve_device(device)
    dtype = compute_dtype(config)
    kernels = unet_kernels(config)
    if checkpoint_exists(config.saved_diffusion_model):
        old = load_config(config.saved_diffusion_model)
        unet = Unet(dim=old.dim, dim_mults=tuple(old.dim_mults), channels=old.channels, dtype=dtype, **kernels)
        state, _ = load_checkpoint(config.saved_diffusion_model, config)
        served = state["params"] if config.serve_raw_params else state.get("ema_params", state["params"])
        unet.load_state_dict(served)
        sched = make_schedule(old.timesteps, old.beta_schedule)
    else:
        print(f"No model found at {config.saved_diffusion_model}. Please load model!")
        unet = init_seeded(
            config.seed,
            lambda: Unet(dim=config.dim, dim_mults=tuple(config.dim_mults), channels=config.channels,
                         dtype=dtype, **kernels),
        )
        sched = make_schedule(config.timesteps, config.beta_schedule)
    return unet.to(dev).eval().requires_grad_(False), sched.to(dev)


@dataclass
class SegTask:
    """A frozen backbone and its head. ``apply`` maps an image batch to
    logits; for a folded head (TEDM) they have ``fold`` * B rows, step-major."""

    unet: Unet
    classifier: PixelClassifier
    sched: DiffusionSchedule
    t_steps: Tuple[int, ...]
    normalize: bool
    fold: int = 1

    def apply(
        self,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> logits (fold*B, out_channels, H, W).
        Noise as in ``extract_features``: ``noise`` (B or S*B rows), else
        drawn from ``generator``. No gradient reaches the backbone; the head
        runs in the mode it is in (``train()`` for a training step)."""
        with torch.no_grad():
            feats = extract_features(
                self.unet, self.sched, x, self.t_steps,
                generator=generator, noise=noise, normalize=self.normalize,
            )
        return self.classifier(feats)


def build_task(config: Config, device: Union[str, torch.device] = "cuda") -> SegTask:
    """The frozen backbone and a freshly initialised head (from
    ``config.seed``) for a LEDM / LEDMe / TEDM config, in eval mode on
    ``device``. The head's parameters take gradients."""
    dev = resolve_device(device)
    unet, sched = load_backbone(config, dev)
    t_steps = tuple(config.t_steps_to_save)
    shared = config.shared_weights_over_timesteps
    clf = init_seeded(
        config.seed + 1,
        lambda: PixelClassifier(
            stage_channels=tuple(config.dim * m for m in reversed(config.dim_mults)),
            n_steps=1 if shared else len(t_steps),
            out_channels=config.out_channels,
            img_size=config.img_size,
            shared=shared,
        ),
    )
    return SegTask(
        unet=unet,
        classifier=clf.to(dev).eval(),
        sched=sched,
        t_steps=t_steps,
        normalize=config.normalize and not config.extract_unnormalized,
        fold=len(t_steps) if shared else 1,
    )


def main(config: Config, device: Union[str, torch.device] = "cuda") -> None:
    """Train a LEDM / LEDMe / TEDM head on JSRT (reference:
    trainers/train_datasetDM.py); checkpoints under ``config.log_dir``."""
    task = build_task(config, device)
    loaders = build_dataloaders(
        "JSRT", config.data_dir, config.img_size, config.batch_size,
        config.num_workers, config.n_labelled_images, seed=config.seed,
        synthetic=config.synthetic_data,
    )
    logger = MetricsLogger(config.log_dir, config, enabled=not config.debug)
    train_segmentation(config, task, loaders, logger)
    logger.close()
