"""Least device times of the port's own kernels, from shapes: a frozen copy
of ``tedm_tpu_torch/kernels/bounds.py`` as it stood when the benchmark was
defined, with the UNet's widths taken from the configuration.

For each kernel call: the bytes it must move (each input read once, each
output written once) over the card's memory rate, and its operations over
the peak rate of the route it takes; the bound is the larger. Rates are
NVIDIA's data-sheet figures for the H100 SXM at its 700 W limit. Where a
kernel keeps fp32 accuracy on the tensor cores by splitting its operands
(an fp32 product as three TF32 products; a bf16 operand's partner as two
bf16 parts), its operations count at that type's rate over the number of
products.

``unit_bounds`` sums them over one unit of a cell's work: one UNet forward
(and, in training, backward) at the unit's batch, for the kernels its
precision and flags put on the path. The ResnetBlock's backward (B.4b) is
left out: its convolution gradients run in cuDNN, so its own launches (the
GroupNorm passes) cannot be held against the whole backward's bound.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
SPLIT_TF32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3
SPLIT_BF16_FLOPS_PER_S = BF16_FLOPS_PER_S / 2
HEADS, DIM_HEAD = 4, 32


def bound_ms(bytes_moved: float, flops: float, flops_per_s: float) -> float:
    return 1e3 * max(bytes_moved / HBM_BYTES_PER_S, flops / flops_per_s)


def unet_stages(dim: int, mults: Sequence[int], size: int) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int, int]]]:
    """(channels, side) of the UNet's linear attentions, and (in, out,
    side) of its ResnetBlocks, in call order."""
    dims = [dim] + [dim * m for m in mults]
    in_out = list(zip(dims[:-1], dims[1:]))
    sides = [size >> i for i in range(len(mults))]
    attn, res = [], []
    for (d_in, _), s in zip(in_out, sides):
        res += [(d_in, d_in, s)] * 2
        attn.append((d_in, s))
    res += [(dims[-1], dims[-1], sides[-1])] * 2
    for (d_in, d_out), s in zip(reversed(in_out), reversed(sides)):
        res += [(d_out + d_in, d_out, s)] * 2
        attn.append((d_out, s))
    res.append((2 * dim, dim, size))
    return attn, res


def linear_attention_call(batch: int, n: int) -> float:
    """B.1, fp32: q, k, v read and out written; two d x d x N contractions
    a head, at fp32's rate."""
    hidden = HEADS * DIM_HEAD
    return bound_ms(4 * 4 * batch * hidden * n, 4 * batch * hidden * DIM_HEAD * n, FP32_FLOPS_PER_S)


def linear_attention_backward_call(batch: int, n: int) -> float:
    """B.1b, fp32: q, k, v, g read, dq, dk, dv written; 10 B*h*d*d*N
    operations, 6 in split TF32 and 4 at fp32's rate."""
    per = batch * HEADS * DIM_HEAD * DIM_HEAD * n
    seconds = 6 * per / SPLIT_TF32_FLOPS_PER_S + 4 * per / FP32_FLOPS_PER_S
    return bound_ms(7 * 4 * batch * HEADS * DIM_HEAD * n, 10 * per, 10 * per / seconds)


def prenorm_attention_call(batch: int, c: int, n: int) -> float:
    """B.2, bf16: the whole Residual(PreNorm(LinearAttention)); x read and
    out written in bf16, the bf16 weights read, fp32 gains and bias."""
    hidden = HEADS * DIM_HEAD
    return bound_ms(2 * 2 * batch * c * n + 2 * (3 * hidden * c + hidden * c) + 4 * 3 * c,
                    2 * batch * n * (3 * hidden * c + hidden * c) + 4 * batch * hidden * DIM_HEAD * n,
                    BF16_FLOPS_PER_S)


def groupnorm_call(batch: int, c: int, hw: int, itemsize: int) -> float:
    """B.3: x read and out written in their dtype; ~10 operations an element."""
    return bound_ms(2 * itemsize * batch * c * hw, 10 * batch * c * hw, FP32_FLOPS_PER_S)


def resblock_call(batch: int, c_in: int, c_out: int, hw: int, itemsize: int) -> float:
    """B.4: the whole ResnetBlock; x read and out written in their dtype,
    the fp32 weights read; its convolutions on the tensor cores (bf16, or
    split TF32)."""
    weights = 9 * c_in * c_out + 9 * c_out * c_out + (c_in * c_out if c_in != c_out else 0)
    return bound_ms(itemsize * batch * (c_in + c_out) * hw + 4 * weights, 2 * batch * hw * weights,
                    BF16_FLOPS_PER_S if itemsize == 2 else SPLIT_TF32_FLOPS_PER_S)


def flash_call(batch: int, n: int, itemsize: int) -> float:
    """B.5: q, k, v read and out written in their dtype; QK^T and PV to fp32
    accuracy (split TF32, or two bf16 parts)."""
    return bound_ms(4 * itemsize * batch * HEADS * DIM_HEAD * n, 4 * batch * HEADS * n * n * DIM_HEAD,
                    SPLIT_BF16_FLOPS_PER_S if itemsize == 2 else SPLIT_TF32_FLOPS_PER_S)


def unit_bounds(dim: int, mults: Sequence[int], size: int, batch: int, bf16: bool, flags: Dict[str, bool],
                backward: bool) -> Dict[str, float]:
    """Each kernel's bound in ms, summed over its calls in one UNet forward
    (and backward) at ``batch``, for the kernels on the path: B.1 (and B.1b
    in a backward) in fp32, B.2 in bf16; B.4 under ``use_pallas_resblock``,
    else B.3 under ``use_pallas_groupnorm``; B.5 under ``use_pallas_flash``."""
    attn, res = unet_stages(dim, mults, size)
    item = 2 if bf16 else 4
    out: Dict[str, float] = {}
    if bf16:
        out["prenorm_linear_attention"] = sum(prenorm_attention_call(batch, c, s * s) for c, s in attn)
    else:
        out["linear_attention"] = sum(linear_attention_call(batch, s * s) for _, s in attn)
        if backward:
            out["linear_attention_backward"] = sum(linear_attention_backward_call(batch, s * s) for _, s in attn)
    if flags.get("use_pallas_resblock"):
        out["fused_resnet_block"] = sum(resblock_call(batch, ci, co, s * s, item) for ci, co, s in res)
    elif flags.get("use_pallas_groupnorm"):
        out["fused_group_norm_film_silu"] = sum(groupnorm_call(batch, co, s * s, item)
                                                for _, co, s in res for _ in range(2))
    if flags.get("use_pallas_flash"):
        mid = size >> (len(mults) - 1)
        out["flash_cosine_attention"] = flash_call(batch, mid * mid, item)
    return out
