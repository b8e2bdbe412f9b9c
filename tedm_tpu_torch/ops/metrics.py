"""Segmentation metrics: per-image Dice / precision / recall, and BCE with
logits (port of ``tedm_tpu/ops/metrics.py``).

Semantics match the reference (trainers/train_baseline.py:146-161): boolean
masks reduced per image and channel, float division so that an empty
denominator gives NaN, aggregated with nanmean (:140-142). Masks are NCHW,
(B, C, H, W), in the port. ``total`` maps each (B, C) count over this
tensor's pixels to the count over the whole image: the identity, or under
spatial parallelism the sum over the row shards (``parallel.spatial.spatial_sum``).
"""

from __future__ import annotations

from typing import Callable

import torch

Total = Callable[[torch.Tensor], torch.Tensor]


def _sum_hw(x: torch.Tensor, total: Total) -> torch.Tensor:
    """(B, C, H, W) -> (B, C) spatial sum in fp32, over the whole image."""
    return total(x.float().sum(dim=(2, 3)))


def _whole(x: torch.Tensor) -> torch.Tensor:
    return x


def dice(pred: torch.Tensor, target: torch.Tensor, total: Total = _whole) -> torch.Tensor:
    """2|A∩B| / (|A|+|B|) per image and channel; NaN if both are empty."""
    p, t = pred.bool(), target.bool()
    return 2.0 * _sum_hw(p & t, total) / (_sum_hw(p, total) + _sum_hw(t, total))


def precision(pred: torch.Tensor, target: torch.Tensor, total: Total = _whole) -> torch.Tensor:
    p, t = pred.bool(), target.bool()
    tp = _sum_hw(t & p, total)
    return tp / (tp + _sum_hw(~t & p, total))


def recall(pred: torch.Tensor, target: torch.Tensor, total: Total = _whole) -> torch.Tensor:
    p, t = pred.bool(), target.bool()
    tp = _sum_hw(t & p, total)
    return tp / (tp + _sum_hw(t & ~p, total))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, in the stable form
    max(x, 0) - x*y + log(1 + exp(-|x|)) that the JAX package uses."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
