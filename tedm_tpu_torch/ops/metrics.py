"""Segmentation metrics: per-image Dice / precision / recall, and BCE with
logits (port of ``tedm_tpu/ops/metrics.py``).

Semantics match the reference (trainers/train_baseline.py:146-161): boolean
masks reduced per image and channel, float division so that an empty
denominator gives NaN, aggregated with nanmean (:140-142). Masks are NCHW,
(B, C, H, W), in the port.
"""

from __future__ import annotations

import torch


def _sum_hw(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C) spatial sum in fp32."""
    return x.float().sum(dim=(2, 3))


def dice(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """2|A∩B| / (|A|+|B|) per image and channel; NaN if both are empty."""
    p, t = pred.bool(), target.bool()
    return 2.0 * _sum_hw(p & t) / (_sum_hw(p) + _sum_hw(t))


def precision(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p, t = pred.bool(), target.bool()
    tp = _sum_hw(t & p)
    return tp / (tp + _sum_hw(~t & p))


def recall(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    p, t = pred.bool(), target.bool()
    tp = _sum_hw(t & p)
    return tp / (tp + _sum_hw(t & ~p))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the stable form
    max(x, 0) - x*y + log(1 + exp(-|x|)) that the JAX package uses."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
