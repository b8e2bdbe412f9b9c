"""Least device times of the repository's TPU kernels on an H100, from shapes.

For each function of ``tedm_tpu/ops/pallas/`` that reaches ``pl.pallas_call``,
at the shapes the JAX package's default UNet (dim 64, mults (1, 2, 4, 8),
128x128) gives it: the bytes it must move (each input read once, each
output written once) over the card's memory rate, and the operations it
does over the card's peak rate for their type; the bound is the larger.
Rates are NVIDIA's data-sheet figures for the H100 SXM at its 700 W limit.

    python -m tedm_tpu_torch.kernels.bounds

prints the bound of each kernel's calls in one serving request (batch 8:
one image at 8 timesteps) and in one training step (batch 16).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
FP32_FLOPS_PER_S = 67e12       # fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # bf16 tensor cores, dense

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
    # 2: the bf16 path's whole Residual(PreNorm(LinearAttention)): x read and
    # out written (bf16), the qkv and to_out weights read; the two 1x1 convs
    # and the attention's contractions on the bf16 tensor cores
    add("prenorm_linear_attention (bf16)", [
        (2 * (2 * batch * c * s * s + 3 * hidden * c + hidden * c),
         2 * batch * s * s * (3 * hidden * c + hidden * c) + 4 * batch * hidden * DIM_HEAD * s * s,
         BF16_FLOPS_PER_S)
        for c, s in attn])
    # 3: GroupNorm + FiLM + SiLU, x read and out written (fp32); about 10
    # operations an element; two per ResnetBlock
    add("fused_group_norm_film_silu", [(2 * 4 * batch * c_out * s * s, 10 * batch * c_out * s * s)
                                       for _, c_out, s in res for _ in range(2)])
    # 4: the whole ResnetBlock, x read and out written, weights read (fp32);
    # two 3x3 convs and the 1x1 res conv where the width changes
    add("fused_resnet_block", [
        (4 * (batch * (c_in + c_out) * s * s + 9 * c_in * c_out + 9 * c_out * c_out
              + (c_in * c_out if c_in != c_out else 0)),
         2 * batch * s * s * (9 * c_in * c_out + 9 * c_out * c_out + (c_in * c_out if c_in != c_out else 0)))
        for c_in, c_out, s in res])
    # 5: the mid attention: q, k, v read and out written (fp32); QK^T and PV
    side = SIZE >> (len(MULTS) - 1)
    n = side * side
    add("flash_cosine_attention", [(4 * 4 * batch * hidden * n, 4 * batch * HEADS * n * n * DIM_HEAD)])
    return out


def main() -> None:
    for label, batch in (("one serving request (batch 8)", 8), ("one training step (batch 16)", 16)):
        print(f"{label}:")
        for name, row in kernel_bounds(batch).items():
            print(f"  {name:34s} {row['calls']:3d} calls  bound {row['bound_ms']:.4f} ms ({row['bound_by']})")


if __name__ == "__main__":
    main()
