"""LEDM / LEDMe / TEDM: the frozen backbone and its feature classifier, in
eval form (port of ``load_backbone`` and ``build_task`` in
``tedm_tpu/trainers/datasetdm.py``; the training loop comes with the
training slice).

A frozen DDPM UNet provides decoder features at ``t_steps_to_save``; a
1x1-conv MLP head classifies each pixel. TEDM
(``shared_weights_over_timesteps``) folds the timesteps into the batch so
one head sees every timestep (reference: trainers/train_datasetDM.py:30-42);
its logits have ``fold`` = S times the batch, step-major.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.models.segmentation import PixelClassifier, extract_features
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.ops.schedules import DiffusionSchedule, make_schedule
from tedm_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, load_config
from tedm_tpu_torch.utils.device import resolve_device


def _init_seeded(seed: int, build):
    """Build modules with torch's default init from ``seed``, leaving the
    caller's global RNG state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def load_backbone(
    config: Config, device: Union[str, torch.device] = "cuda"
) -> Tuple[Unet, DiffusionSchedule]:
    """The frozen diffusion backbone (reference: models/datasetDM_model.py:31-44)
    in eval mode on ``device``, with its schedule: restored from
    ``config.saved_diffusion_model`` when a checkpoint is there (its EMA
    weights when present, unless ``serve_raw_params``), else initialised from
    ``config.seed`` with a warning."""
    dev = resolve_device(device)
    if checkpoint_exists(config.saved_diffusion_model):
        old = load_config(config.saved_diffusion_model)
        unet = Unet(dim=old.dim, dim_mults=tuple(old.dim_mults), channels=old.channels)
        state, _ = load_checkpoint(config.saved_diffusion_model, config)
        served = state["params"] if config.serve_raw_params else state.get("ema_params", state["params"])
        unet.load_state_dict(served)
        sched = make_schedule(old.timesteps, old.beta_schedule)
    else:
        print(f"No model found at {config.saved_diffusion_model}. Please load model!")
        unet = _init_seeded(
            config.seed,
            lambda: Unet(dim=config.dim, dim_mults=tuple(config.dim_mults), channels=config.channels),
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
        Noise as in ``extract_features``: ``noise`` reused for every step,
        else drawn from ``generator``. No gradient reaches the backbone."""
        with torch.no_grad():
            feats = extract_features(
                self.unet, self.sched, x, self.t_steps,
                generator=generator, noise=noise, normalize=self.normalize,
            )
        return self.classifier(feats)


def build_task(config: Config, device: Union[str, torch.device] = "cuda") -> SegTask:
    """The backbone and a freshly initialised head (from ``config.seed``) for
    a LEDM / LEDMe / TEDM config, in eval mode on ``device``."""
    dev = resolve_device(device)
    unet, sched = load_backbone(config, dev)
    t_steps = tuple(config.t_steps_to_save)
    shared = config.shared_weights_over_timesteps
    clf = _init_seeded(
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
