"""Least device times of the repository's TPU kernels on an H100, from shapes.

For each function of ``tedm_tpu/ops/pallas/`` that reaches ``pl.pallas_call``,
at the shapes the JAX package's default UNet (dim 64, mults (1, 2, 4, 8),
128x128) gives it: the bytes it must move (each input read once, each
output written once) over the card's memory rate, and the operations it
does over the card's peak rate for their type; the bound is the larger.
Rates are NVIDIA's data-sheet figures for the H100 SXM at its 700 W limit.
Where a kernel keeps fp32 accuracy on the tensor cores by splitting its
operands (an fp32 product as hi*hi + hi*lo + lo*hi, three TF32 products;
with bf16 inputs, which are exact in bf16, the other operand as two bf16
parts, two bf16 products), its operations are counted at the tensor-core
rate of that type over the number of products: the least time of the route
the kernel takes.

    python -m tedm_tpu_torch.kernels.bounds

prints the bound of each kernel's calls in one serving request (batch 8:
one image at 8 timesteps) and in one training step (batch 16), in fp32 and,
for the kernels that run in both dtypes, in bf16 (the ResnetBlock's
backward is a training step's only). ``chip_smoke.py`` takes
the per-call functions for the shapes it times.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
FP32_FLOPS_PER_S = 67e12       # fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12      # TF32 tensor cores, dense
SPLIT_TF32_FLOPS_PER_S = TF32_FLOPS_PER_S / 3   # an fp32 product as three TF32 products
SPLIT_BF16_FLOPS_PER_S = BF16_FLOPS_PER_S / 2  # a product with a bf16 operand as two bf16 products

DIM, MULTS, SIZE = 64, (1, 2, 4, 8), 128
HEADS, DIM_HEAD = 4, 32


def bound(bytes_moved: float, flops: float, flops_per_s: float = FP32_FLOPS_PER_S) -> Dict:
    """{"bound_ms", "bound_by"}: the larger of the two least times."""
    bytes_ms, ops_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S, 1e3 * flops / flops_per_s
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def unet_stages() -> Tuple[List[Tuple[int, int]], List[Tuple[int, int, int]]]:
    """The default UNet's (channels, side) of its 8 linear attentions, and
    (in_channels, out_channels, side) of its 19 ResnetBlocks, in call order
    (tedm_tpu/models/unet.py; the port's models/unet.py)."""
    dims = [DIM] + [DIM * m for m in MULTS]
    in_out = list(zip(dims[:-1], dims[1:]))
    sides = [SIZE >> i for i in range(len(MULTS))]
    attn, res = [], []
    for (d_in, _), s in zip(in_out, sides):
        res += [(d_in, d_in, s)] * 2
        attn.append((d_in, s))
    res += [(dims[-1], dims[-1], sides[-1])] * 2
    for (d_in, d_out), s in zip(reversed(in_out), reversed(sides)):
        res += [(d_out + d_in, d_out, s)] * 2
        attn.append((d_out, s))
    res.append((2 * DIM, DIM, SIZE))
    return attn, res


def prenorm_attention_call(batch: int, c: int, n: int) -> Tuple[float, float, float]:
    """(bytes, operations, rate) of one bf16 Residual(PreNorm(LinearAttention))
    over (batch, c, n): x read and out written in bf16, W_qkv and W_out
    read in bf16 (the kernel's fragment layout, built once per weight
    version) and the gains and bias in fp32; the qkv and to_out products and
    the two head-blocked attention contractions on the bf16 tensor cores."""
    hidden = HEADS * DIM_HEAD
    return (2 * 2 * batch * c * n + 2 * (3 * hidden * c + hidden * c) + 4 * 3 * c,
            2 * batch * n * (3 * hidden * c + hidden * c) + 4 * batch * hidden * DIM_HEAD * n, BF16_FLOPS_PER_S)


def groupnorm_call(batch: int, c: int, hw: int, itemsize: int = 4) -> Tuple[float, float, float]:
    """(bytes, operations, rate) of one GroupNorm+FiLM+SiLU over (batch, c,
    hw pixels): x read and out written in their dtype; about 10 operations
    an element on the CUDA cores."""
    return 2 * itemsize * batch * c * hw, 10 * batch * c * hw, FP32_FLOPS_PER_S


def resblock_call(batch: int, c_in: int, c_out: int, hw: int, itemsize: int = 4) -> Tuple[float, float, float]:
    """(bytes, operations, rate) of one whole ResnetBlock: x read and out
    written in their dtype, the fp32 weights read; the two 3x3 convs and
    the 1x1 res conv where the width changes, on the tensor cores: bf16, or
    in fp32 split TF32."""
    weights = 9 * c_in * c_out + 9 * c_out * c_out + (c_in * c_out if c_in != c_out else 0)
    return (itemsize * batch * (c_in + c_out) * hw + 4 * weights, 2 * batch * hw * weights,
            BF16_FLOPS_PER_S if itemsize == 2 else SPLIT_TF32_FLOPS_PER_S)


def resblock_backward_call(batch: int, c_in: int, c_out: int, hw: int, itemsize: int = 4) -> Tuple[float, float, float]:
    """(bytes, operations, rate) of one whole ResnetBlock's backward: x and
    dout read and dx written in their dtype, the fp32 h1 and h2 the forward
    keeps read, the fp32 weights read and their gradients written; each of
    the three convolutions' data and weight gradients (twice the forward's
    operations; conv1's data gradient only where x needs it, which the
    UNet's first block's does too), on the tensor cores in bf16, or as fp32
    products outside them (TF32 off)."""
    weights = 9 * c_in * c_out + 9 * c_out * c_out + (c_in * c_out if c_in != c_out else 0)
    acts = itemsize * batch * hw * (2 * c_in + c_out) + 4 * 2 * batch * c_out * hw
    return (acts + 2 * 4 * weights, 2 * 2 * batch * hw * weights,
            BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S)


def flash_call(batch: int, n: int, itemsize: int = 4) -> Tuple[float, float, float]:
    """(bytes, operations, rate) of one cosine attention over (batch, 4, 32,
    n): q, k, v read and out written in their dtype; QK^T and PV to fp32
    accuracy, as the JAX kernel runs them at Precision.HIGHEST: split TF32,
    three products; with bf16 k and v, the folded q and the probabilities as
    two bf16 parts, two bf16 products."""
    return (4 * itemsize * batch * HEADS * DIM_HEAD * n, 4 * batch * HEADS * n * n * DIM_HEAD,
            SPLIT_BF16_FLOPS_PER_S if itemsize == 2 else SPLIT_TF32_FLOPS_PER_S)


def kernel_bounds(batch: int) -> Dict[str, Dict]:
    """Each kernel's bound summed over its calls in one forward (and, for
    the linear-attention backward, one backward) at ``batch``."""
    attn, res = unet_stages()
    hidden = HEADS * DIM_HEAD
    out: Dict[str, Dict] = {}

    def add(name, calls):
        rows = [bound(*c) for c in calls]
        out[name] = {"calls": len(rows), "bound_ms": sum(r["bound_ms"] for r in rows),
                     "bound_by": "/".join(sorted({r["bound_by"] for r in rows}))}

    # 1: q, k, v read and out written, fp32; two d x d x N contractions per (b, h)
    add("linear_attention", [(4 * 4 * batch * hidden * s * s, 4 * batch * hidden * DIM_HEAD * s * s)
                             for _, s in attn])
    # 1b: q, k, v, g read and dq, dk, dv written, fp32; the JAX cost estimate's
    # 10 * B*h*d*d*N (ops/pallas/linear_attention.py:152)
    add("linear_attention backward", [(7 * 4 * batch * hidden * s * s, 10 * batch * hidden * DIM_HEAD * s * s)
                                      for _, s in attn])
    # 2: the bf16 path's whole Residual(PreNorm(LinearAttention))
    add("prenorm_linear_attention (bf16)", [prenorm_attention_call(batch, c, s * s) for c, s in attn])
    mid = SIZE >> (len(MULTS) - 1)
    for suffix, itemsize in (("", 4), (" (bf16)", 2)):
        # 3: two per ResnetBlock, of its output width
        add("fused_group_norm_film_silu" + suffix,
            [groupnorm_call(batch, c_out, s * s, itemsize) for _, c_out, s in res for _ in range(2)])
        # 4: the whole ResnetBlock; its bound is its convolutions' arithmetic
        add("fused_resnet_block" + suffix, [resblock_call(batch, c_in, c_out, s * s, itemsize)
                                            for c_in, c_out, s in res])
        # 4b: its backward (training only)
        add("fused_resnet_block backward" + suffix, [resblock_backward_call(batch, c_in, c_out, s * s, itemsize)
                                                     for c_in, c_out, s in res])
        # 5: the mid attention
        add("flash_cosine_attention" + suffix, [flash_call(batch, mid * mid, itemsize)])
    return out


def main() -> None:
    for label, batch in (("one serving request (batch 8)", 8), ("one training step (batch 16)", 16)):
        print(f"{label}:")
        for name, row in kernel_bounds(batch).items():
            print(f"  {name:34s} {row['calls']:3d} calls  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")


if __name__ == "__main__":
    main()
