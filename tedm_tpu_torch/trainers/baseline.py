"""The supervised UNet segmentation baseline on JSRT (port of
``tedm_tpu/trainers/baseline.py``; reference: trainers/train_baseline.py:164-211).

The UNet runs with ``time=None``, no FiLM conditioning, as the reference's
``model(x)`` call (train_baseline.py:37), on the image in [0, 1]. It keeps
its time MLPs, so its parameters (and their count) are the diffusion
UNet's; they get no gradient, and torch's optimizers leave a parameter
without one as it is. The whole UNet is trained by the shared loop
(``trainers/common.py``); the checkpoint holds it under ``unet``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Dict, Optional, Tuple, Union

import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.pipeline import build_dataloaders
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.parallel import mesh
from tedm_tpu_torch.trainers.common import compute_dtype, init_seeded, train_segmentation, unet_kernels
from tedm_tpu_torch.utils.device import resolve_device
from tedm_tpu_torch.utils.logging import MetricsLogger


@dataclass
class BaselineTask:
    """The UNet as a segmenter: ``apply`` maps an image batch in [0, 1] to
    fp32 logits (B, out_channels, H, W); the noise arguments of the heads'
    tasks are accepted and unused."""

    TRAINED: ClassVar[str] = "unet"  # the field of the trained module
    unet: Unet
    fold: int = 1
    t_steps: Tuple[int, ...] = ()

    @property
    def modules(self) -> Dict[str, torch.nn.Module]:
        return {"unet": self.unet}

    @property
    def trained(self) -> torch.nn.Module:
        return self.unet

    def apply(
        self,
        x: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        return self.unet(x, None).float()


def build_task(config: Config, device: Union[str, torch.device] = "cuda") -> BaselineTask:
    """A UNet initialised from ``config.seed`` with torch's default init, in
    the compute dtype and with the opt-in kernels of ``config``, on
    ``device``: ``config.channels`` in, ``config.out_channels`` out."""
    dev = resolve_device(device)
    unet = init_seeded(
        config.seed,
        lambda: Unet(dim=config.dim, dim_mults=tuple(config.dim_mults), channels=config.out_channels,
                     in_channels=config.channels, dtype=compute_dtype(config), **unet_kernels(config)),
    )
    return BaselineTask(unet=unet.to(dev).eval())


def main(config: Config, device: Union[str, torch.device] = "cuda") -> None:
    """Train the baseline on JSRT; checkpoints under ``config.log_dir``."""
    task = build_task(config, device)
    loaders = build_dataloaders(
        "JSRT", config.data_dir, config.img_size, config.batch_size,
        config.num_workers, config.n_labelled_images, seed=config.seed,
        synthetic=config.synthetic_data, splits_dir=config.splits_dir,
        backend=config.data_backend, device=device, **mesh.loader_shard(),
    )
    print(f"Loaded {len(loaders['train'].indices)} training and "
          f"{len(loaders['val'].indices)} validation images")
    logger = MetricsLogger(config.log_dir, config, enabled=not config.debug)
    train_segmentation(config, task, loaders, logger)
    logger.close()
