"""Nearest-neighbour resize in NCHW (port of ``tedm_tpu/ops/resize.py``).

``nearest_resize`` has ``torch.nn.functional.interpolate(mode='nearest')``
semantics (source index = floor(dst * src/dst)), which the JAX package
reproduces; integral upscales reduce to ``repeat_interleave``.
"""

from __future__ import annotations

import torch


def nearest_upsample_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), exact nearest for factor 2."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def nearest_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') semantics on (B, C, H, W)."""
    h, w = x.shape[2], x.shape[3]
    if out_h % h == 0 and out_w % w == 0:
        return x.repeat_interleave(out_h // h, dim=2).repeat_interleave(out_w // w, dim=3)
    rows = torch.floor(torch.arange(out_h, device=x.device) * (h / out_h)).long()
    cols = torch.floor(torch.arange(out_w, device=x.device) * (w / out_w)).long()
    return x[:, :, rows][:, :, :, cols]
