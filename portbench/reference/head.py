"""The plain reference of TEDM's prediction: q_sample at the folded
timesteps, the UNet's decoder features, the shared pixel classifier, the
mean of the sigmoids over timesteps.

The classifier is datasetDM's 1x1-conv MLP (mmr12/TEDM
models/datasetDM_model.py:57-64) behind the parameter-free layer that leads
the shared-weights head: Conv(960 -> 128), ReLU, BatchNorm, Conv(-> 32),
ReLU, BatchNorm, Conv(-> 1), on the concatenation of the four stages, each
nearest-upsampled to the image size. BatchNorm runs on its running
statistics (a served model is in eval mode).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import unet as ref_unet
from portbench.reference.diffusion import Schedule


class PixelClassifier(nn.Sequential):
    def __init__(self, channels: int, hidden: Sequence[int] = (128, 32), out_channels: int = 1):
        super().__init__(
            nn.Identity(),
            ref_unet.Conv2d(channels, hidden[0], 1), nn.ReLU(), nn.BatchNorm2d(hidden[0], eps=1e-5),
            ref_unet.Conv2d(hidden[0], hidden[1], 1), nn.ReLU(), nn.BatchNorm2d(hidden[1], eps=1e-5),
            ref_unet.Conv2d(hidden[1], out_channels, 1),
        )

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        size = feats[-1].shape[-1]
        x = torch.cat([F.interpolate(f, size=(size, size), mode="nearest") for f in feats], dim=1)
        return super().forward(x)


def probabilities(unet: nn.Module, head: nn.Module, sched: Schedule, images: torch.Tensor,
                  t_steps: Sequence[int], noise: torch.Tensor) -> torch.Tensor:
    """images (B, 1, H, W) in [0, 1]; ``noise`` (S*B, 1, H, W) step-major
    (step s on rows [s*B, (s+1)*B)). Returns the mean over the S timesteps
    of the sigmoid of the head's logits, (B, 1, H, W)."""
    b, s = images.shape[0], len(t_steps)
    x0 = (images * 2 - 1).repeat(s, 1, 1, 1)
    t = torch.tensor(list(t_steps), device=images.device).repeat_interleave(b)
    _, feats = unet(sched.q_sample(x0, t, noise), t, features=True)
    return torch.sigmoid(head(feats)).reshape(s, b, *images.shape[1:]).mean(dim=0)
