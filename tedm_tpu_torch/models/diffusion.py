"""Forward diffusion (port of the serving part of ``tedm_tpu/models/diffusion.py``).

Sampling and the training losses come with the training slice.
"""

from __future__ import annotations

import torch

from tedm_tpu_torch.ops.schedules import DiffusionSchedule, extract


def normalize_to_neg_one_to_one(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 - 1.0


def q_sample(
    sched: DiffusionSchedule, x_0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """x_t = sqrt(a_bar_t) x_0 + sqrt(1-a_bar_t) eps
    (reference: models/diffusion_model.py:176-203). ``sched`` lies on x_0's device."""
    a = extract(sched.sqrt_alphas_cumprod, t, x_0.ndim)
    b = extract(sched.sqrt_one_minus_alphas_cumprod, t, x_0.ndim)
    return a * x_0 + b * noise
