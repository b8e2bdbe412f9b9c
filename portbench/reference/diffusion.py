"""The plain reference of the DDPM process: the beta schedule, q_sample and
the training loss (mmr12/TEDM models/diffusion_model.py: the schedules
:16-47, the buffers :82-115, the L1 epsilon loss with p2 reweighting
:120-143). The tables are computed in float64 and kept in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def betas(timesteps: int, schedule: str) -> np.ndarray:
    if schedule == "cosine":
        s = 0.008
        x = np.linspace(0.0, timesteps, timesteps + 1, dtype=np.float64)
        ac = np.cos(((x / timesteps) + s) / (1 + s) * math.pi * 0.5) ** 2
        ac = ac / ac[0]
        return np.clip(1.0 - ac[1:] / ac[:-1], 0.0, 0.999)
    if schedule == "linear":
        scale = 1000.0 / timesteps
        return np.clip(np.linspace(scale * 1e-4, scale * 0.02, timesteps, dtype=np.float64), 0.0, 0.999)
    raise ValueError(f"unknown beta schedule {schedule}")


class Schedule:
    """sqrt(a_bar), sqrt(1 - a_bar) and the p2 loss weights, each (T,)."""

    def __init__(self, timesteps: int = 1000, schedule: str = "cosine", p2_gamma: float = 0.0,
                 p2_k: float = 1.0, device="cpu"):
        ac = np.cumprod(1.0 - betas(timesteps, schedule))
        f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
        self.sqrt_ac = f32(np.sqrt(ac))
        self.sqrt_1m_ac = f32(np.sqrt(1.0 - ac))
        self.p2 = f32((p2_k + ac / (1.0 - ac)) ** (-p2_gamma))

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        col = lambda a: a[t].reshape(-1, *([1] * (x0.ndim - 1)))
        return col(self.sqrt_ac) * x0 + col(self.sqrt_1m_ac) * noise

    def loss_sum(self, out: torch.Tensor, noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The sum over rows of each row's p2-weighted mean |out - noise|
        (the epsilon objective); divide by the batch for the loss."""
        per_row = (out - noise).abs().reshape(out.shape[0], -1).mean(dim=1)
        return (per_row * self.p2[t]).sum()
