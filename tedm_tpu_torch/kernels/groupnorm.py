"""GroupNorm -> FiLM -> SiLU, plain PyTorch version.

Port of ``group_norm_film_silu_reference`` in
``tedm_tpu/ops/pallas/groupnorm.py:159-189``, in the port's NCHW layout
(a group's channels are contiguous there). The CUDA kernel that replaces the
opt-in Pallas ``fused_group_norm_film_silu`` is ROADMAP item B.3; the
serving path at default settings runs this version on every device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def group_norm_film_silu_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x (B, C, H, W); gamma, beta (C,); scale, shift (B, C) or None.

    Same formula as the JAX package: fp32 statistics with the one-pass
    variance E[x^2] - mean^2 clamped at 0, then gamma/beta, then
    x * (scale + 1) + shift, then SiLU; output in x's dtype.
    """
    b, c, h, w = x.shape
    xf = x.float().reshape(b, groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    ex2 = (xf * xf).mean(dim=2, keepdim=True)
    var = torch.clamp(ex2 - mean * mean, min=0.0)
    xhat = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w)
    f = xhat * gamma.float()[:, None, None] + beta.float()[:, None, None]
    if scale is not None:
        f = f * (scale.float()[:, :, None, None] + 1.0)
    if shift is not None:
        f = f + shift.float()[:, :, None, None]
    return F.silu(f).to(x.dtype)
