"""DDPM beta schedules and derived coefficient tables (port of
``tedm_tpu/ops/schedules.py``; reference: models/diffusion_model.py:16-47
for the schedules, :82-115 for the derived buffers).

The tables are computed in float64 with numpy and rounded to float32 tensors,
exactly as the JAX package does, so both packages hold bit-identical tables.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def _linear_betas_f64(timesteps: int, start: float = 1e-4, end: float = 0.02) -> np.ndarray:
    scale = 1000.0 / timesteps
    betas = np.linspace(scale * start, scale * end, timesteps, dtype=np.float64)
    # the 1000/T scaling pushes beta past 1 for T < 50, which would make
    # every derived sqrt NaN; a no-op at the reference T=1000
    return np.clip(betas, 0.0, 0.999)


def _cosine_betas_f64(timesteps: int, s: float = 0.008) -> np.ndarray:
    x = np.linspace(0.0, float(timesteps), timesteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0.0, 0.999)


class DiffusionSchedule(NamedTuple):
    """Per-timestep coefficients, each a float32 tensor of shape (T,)."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    p2_loss_weight: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(*(t.to(device) for t in self))


def make_schedule(
    timesteps: int = 1000,
    beta_schedule: str = "cosine",
    p2_loss_weight_gamma: float = 0.0,
    p2_loss_weight_k: float = 1.0,
) -> DiffusionSchedule:
    if beta_schedule == "linear":
        betas = _linear_betas_f64(timesteps)
    elif beta_schedule == "cosine":
        betas = _cosine_betas_f64(timesteps)
    else:
        raise ValueError(f"unknown beta schedule {beta_schedule}")

    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    p2_loss_weight = (
        p2_loss_weight_k + alphas_cumprod / (1.0 - alphas_cumprod)
    ) ** (-p2_loss_weight_gamma)

    def f32(x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, dtype=np.float32))

    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(np.log(np.clip(posterior_variance, 1e-20, None))),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
        ),
        p2_loss_weight=f32(p2_loss_weight),
    )


def gather(table: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``table[t]`` with t clamped to [0, T-1], as JAX clamps an
    out-of-range gather: a TEDM head (timesteps up to 800) on a backbone of
    T <= 800 steps reads the last entry, where strict indexing would raise
    (and, on the card, trip a device-side assert)."""
    return table[t.clamp(0, table.shape[0] - 1)]


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-sample coefficients at t:(B,) (clamped, see ``gather``) and
    shape them (B, 1, ..., 1) to broadcast against an ndim image batch
    (reference: trainers/utils.py:48-59)."""
    out = gather(table, t)
    return out.reshape(out.shape[0], *((1,) * (ndim - 1)))
