"""Operand rounding of the reference's products, for the controls and for
the training reference of a bf16 configuration.

The reference computes in fp32. Its control computes every product of the
network (convolutions, linear layers, attention contractions) on operands
rounded to the precision just below the configuration's, with fp32 sums, as
the card's tensor cores do: TF32 for an fp32 configuration, fp8 (e4m3, one
scale a tensor, as fp8 training scales it) for a bf16 one. The training
reference of a bf16 configuration computes in the precision it states:
products on bf16 operands with fp32 sums, and the UNet's output in bf16
(``stored``); its control stores that output in fp8. Rounding in software
gives the same numbers on the CPU and on the card.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10 mantissa bits, to nearest, ties away
    from zero (the card's ``cvt.rna.tf32.f32``)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).view(t.shape)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """fp32 values through float8_e4m3fn with one scale for the tensor, its
    largest magnitude mapped to 448."""
    tf = t.float()
    scale = tf.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (tf / scale).to(torch.float8_e4m3fn).float() * scale


def bf16(t: torch.Tensor) -> torch.Tensor:
    """fp32 values through bfloat16, to nearest even."""
    return t.float().to(torch.bfloat16).float()


def control_rounding(precision: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The rounding of the control for a configuration computing in
    ``precision`` (``fp32`` or ``bf16``)."""
    return {"fp32": tf32, "bf16": fp8}[precision]


def stored(precision: str) -> Rounding:
    """The rounding of a configuration's stored values, the UNet's output
    among them: none in ``fp32``, bf16's in ``bf16``."""
    return {"fp32": None, "bf16": bf16}[precision]


def control_stored(precision: str) -> Rounding:
    """The same for the control: fp8 below bf16; TF32 stores nothing."""
    return {"fp32": None, "bf16": fp8}[precision]


class _Round(torch.autograd.Function):
    """``rounding`` of the values going forward and of their gradient going
    back, so that a product's backward also runs on rounded numbers."""

    @staticmethod
    def forward(ctx, t, rounding):
        ctx.rounding = rounding
        return rounding(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.rounding(g), None


def apply(rounding: Rounding, *ts: torch.Tensor):
    """``ts`` rounded by ``rounding``, or as they are without one."""
    if rounding is not None:
        ts = tuple(_Round.apply(t, rounding) for t in ts)
    return ts if len(ts) > 1 else ts[0]
