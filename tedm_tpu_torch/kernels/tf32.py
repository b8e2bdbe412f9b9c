"""TF32 rounding and the split of fp32 values into two TF32 parts, as the
kernels that keep fp32 accuracy on the tensor cores compute them
(``csrc/tensor_core.cuh``: ``to_tf32``, ``split``). The CPU tests use them
to emulate those kernels' products; ``resblock.tc_weight_layout`` uses them
to lay out fp32 weights."""

from __future__ import annotations

from typing import Tuple

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 explicit mantissa bits, nearest,
    ties away from zero), as the card's ``cvt.rna.tf32.f32`` rounds."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with t = hi + lo to 2**-22 of |t|: hi its TF32 rounding, lo
    the TF32 rounding of the rest. hi*hi + hi*lo + lo*hi is the product the
    kernels' split-TF32 route computes."""
    hi = tf32_round(t)
    return hi, tf32_round(t.float() - hi)


def split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in fp32 as the split-TF32 route computes it: lo*hi + hi*lo +
    hi*hi, each product of TF32 values exact in fp32, summed in fp32."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh
