"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a card raises:
    the port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def strict_fp32() -> None:
    """fp32 means fp32 on the card: no TF32 in cuDNN's convolutions (on by
    default) or in matrix products, as the tolerances against the JAX
    package assume; and a bf16 product sums in fp32, with no bf16 split-K
    reduction (on by default), as JAX's preferred_element_type=float32 does.
    The entry points' ``main`` functions call it."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
