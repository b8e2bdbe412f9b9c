"""Operations of a whole unit of a cell's work, from shapes: the UNet's
convolutions, linear layers and attention contractions, and TEDM's head;
2 operations a multiply-add, as torch's FLOP counter counts them. Norms,
activations and other elementwise work are not counted.

A backward costs twice its forward, less the data gradients that nothing
needs: those of the first convolution (its input is the noised image) and
of the time MLP's first linear layer (its input is the sinusoidal
embedding). The head's first layer runs on each stage at the stage's own
size (the upsample of a 1x1 convolution is the 1x1 convolution of the
upsample), which is the least the layer needs.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

HEADS, DIM_HEAD = 4, 32


def _conv(c_in: int, c_out: int, k: int, side: int) -> int:
    return 2 * c_in * c_out * k * k * side * side


def unet_ops(dim: int, mults: Sequence[int], size: int, channels: int = 1) -> List[Tuple[str, int]]:
    """(kind, operations) of each product of one image's UNet forward."""
    dims = [dim] + [dim * m for m in mults]
    in_out = list(zip(dims[:-1], dims[1:]))
    time_dim = 4 * dim
    hidden = HEADS * DIM_HEAD
    ops: List[Tuple[str, int]] = [("input_conv", _conv(channels, dim, 7, size)),
                                  ("time_embedding", 2 * dim * time_dim), ("linear", 2 * time_dim * time_dim)]

    def resnet(c_in, c_out, side):
        ops.append(("linear", 2 * time_dim * 2 * c_out))
        ops.append(("conv", _conv(c_in, c_out, 3, side)))
        ops.append(("conv", _conv(c_out, c_out, 3, side)))
        if c_in != c_out:
            ops.append(("conv", _conv(c_in, c_out, 1, side)))

    def linear_attention(c, side):
        n = side * side
        ops.append(("conv", _conv(c, 3 * hidden, 1, side)))
        ops.append(("attention", 2 * 2 * HEADS * DIM_HEAD * DIM_HEAD * n))
        ops.append(("conv", _conv(hidden, c, 1, side)))

    side = size
    for i, (d_in, d_out) in enumerate(in_out):
        resnet(d_in, d_in, side)
        resnet(d_in, d_in, side)
        linear_attention(d_in, side)
        last = i == len(in_out) - 1
        ops.append(("conv", _conv(d_in, d_out, 3, side) if last else 2 * d_in * d_out * 16 * (side // 2) ** 2))
        side = side if last else side // 2
    mid = dims[-1]
    resnet(mid, mid, side)
    n = side * side
    ops.append(("conv", _conv(mid, 3 * hidden, 1, side)))
    ops.append(("attention", 2 * 2 * HEADS * n * n * DIM_HEAD))
    ops.append(("conv", _conv(hidden, mid, 1, side)))
    resnet(mid, mid, side)
    for i, (d_in, d_out) in enumerate(reversed(in_out)):
        resnet(d_out + d_in, d_out, side)
        resnet(d_out + d_in, d_out, side)
        linear_attention(d_out, side)
        last = i == len(in_out) - 1
        side = side if last else side * 2
        ops.append(("conv", _conv(d_out, d_in, 3, side)))
    resnet(2 * dim, dim, size)
    ops.append(("conv", _conv(dim, channels, 1, size)))
    return ops


def unet_forward(dim: int, mults: Sequence[int], size: int, channels: int = 1) -> int:
    return sum(n for _, n in unet_ops(dim, mults, size, channels))


def unet_train(dim: int, mults: Sequence[int], size: int, channels: int = 1) -> int:
    """Forward and backward of one image: every product's weight gradient and
    every data gradient that the forward's inputs need."""
    ops = unet_ops(dim, mults, size, channels)
    no_data_grad = sum(n for kind, n in ops if kind in ("input_conv", "time_embedding"))
    return 3 * sum(n for _, n in ops) - no_data_grad


def head_forward(stage_channels: Sequence[int], stage_sides: Sequence[int], size: int,
                 hidden: Sequence[int] = (128, 32), out_channels: int = 1) -> int:
    """The pixel classifier on one row of features."""
    first = sum(2 * c * hidden[0] * s * s for c, s in zip(stage_channels, stage_sides))
    return first + 2 * size * size * (hidden[0] * hidden[1] + hidden[1] * out_channels)


def unit_flops(cfg: Dict, traffic: Dict) -> float:
    """Operations of one unit of a cell: a training step of ``batch`` images,
    or one served request of one image at its folded timesteps."""
    dim, mults, size = cfg["dim"], cfg["dim_mults"], cfg["img_size"]
    if traffic["driver"] == "train_step":
        return traffic["batch"] * unet_train(dim, mults, size, cfg["channels"])
    fold = len(cfg["t_steps"])
    stages = [dim * m for m in reversed(mults)]
    sides = [size >> i for i in reversed(range(len(mults)))]
    return fold * (unet_forward(dim, mults, size, cfg["channels"]) + head_forward(stages, sides, size))
