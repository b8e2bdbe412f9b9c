"""The weight layout of the port's fused PreNorm linear-attention kernel (B.2).

The kernel (``csrc/attn_block.cu``) reads W_qkv, W_out and each image's
context as the A operands of ``mma.sync`` m16n8k16 products, one 16-byte
load a lane a 16 x 16 fragment. ``fragment_layout`` builds that order for
the weights; the kernel's ``frag_index32`` writes the context in it. Both
are pinned here on the CPU: the layout read back by the fragment rule
(lane l = 4 g + t holds a0 = (g, 2t..2t+1), a1 = (g + 8, 2t..), a2 = (g,
2t + 8..), a3 = (g + 8, 2t + 8..)) is the matrix; products formed from
the fragments as the tensor cores form them equal the matrix product; and
the layout is built once per weight version. The kernel itself runs only on
the card (``chip_smoke.py`` phase 3 holds it against the plain version).
"""

import numpy as np
import pytest
import torch

from tedm_tpu_torch.kernels import attn_block as AB


def _read_fragments(layout: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """The (m, k) matrix a fragment layout holds, read by the mma.sync rule:
    fragment (mt, kt) is 32 lanes x 4 registers x 2 values, contiguous."""
    frags = layout.reshape(m // 16, k // 16, 32, 4, 2)
    out = torch.empty(m, k, dtype=layout.dtype)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
            for pair in range(2):
                rows = torch.arange(m // 16)[:, None] * 16 + g + dr
                cols = torch.arange(k // 16)[None, :] * 16 + 2 * t + dc + pair
                out[rows, cols] = frags[:, :, lane, j, pair]
    return out


@pytest.mark.parametrize("m,k", [(384, 64), (384, 512), (64, 128), (512, 128), (16, 16)])
def test_fragment_layout_reads_back_the_matrix(m, k):
    w = torch.from_numpy(np.random.RandomState(m + k).randn(m, k).astype(np.float32))
    layout = AB.fragment_layout(w)
    assert layout.dtype == torch.bfloat16 and layout.is_contiguous() and layout.numel() == m * k
    assert torch.equal(_read_fragments(layout, m, k), w.to(torch.bfloat16))


def _mma_product(layout: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """W y with W's fragments as the tensor cores combine them: for each
    16 x 16 fragment, lane (g, t)'s a0..a3 times B's k-rows (2t, 2t+1,
    2t+8, 2t+9), summed over k-tiles in fp32."""
    k, n = y.shape
    frags = layout.reshape(-1, k // 16, 32, 4, 2).float()
    m = frags.shape[0] * 16
    out = torch.zeros(m, n)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for j, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
            for pair in range(2):
                kk = torch.arange(k // 16) * 16 + 2 * t + dc + pair
                rows = torch.arange(m // 16) * 16 + g + dr
                out[rows] += frags[:, :, lane, j, pair] @ y[kk].float()
    return out


def test_fragment_products_are_the_matrix_product():
    """On integer values, exact in bf16 and in any order of fp32 sums."""
    rs = np.random.RandomState(0)
    w = torch.from_numpy(rs.randint(-8, 9, (128, 96)).astype(np.float32))
    y = torch.from_numpy(rs.randint(-8, 9, (96, 40)).astype(np.float32))
    assert torch.equal(_mma_product(AB.fragment_layout(w), y), w @ y)


def _frag_index32(row: int, col: int) -> int:
    """csrc/attn_block.cu's frag_index32, where the kernel writes element
    (row, col) of a head's 32 x 32 context operand."""
    mt, r, g = row >> 4, (row >> 3) & 1, row & 7
    kt, c8, t = col >> 4, (col >> 3) & 1, (col >> 1) & 3
    return (((mt * 2 + kt) * 32 + 4 * g + t) * 4 + 2 * c8 + r) * 2 + (col & 1)


def test_context_index_is_the_fragment_layout():
    """The kernel writes each image's context where fragment_layout would
    put it, so pass 2 reads it by the same rule as the weights."""
    ctx = torch.arange(32 * 32, dtype=torch.float32).reshape(32, 32)  # exact in bf16 up to 256
    ctx = ctx % 251
    flat = AB.fragment_layout(ctx).reshape(-1)
    for row in range(32):
        for col in range(32):
            assert flat[_frag_index32(row, col)] == ctx[row, col].to(torch.bfloat16)


def test_fragment_layouts_are_cached_per_version():
    """Each matrix is laid out once per weight version and storage: a served
    model builds its two layouts once; an in-place update builds them again."""
    w = torch.nn.Parameter(torch.randn(384, 64, 1, 1))
    built = AB.prenorm_linear_attention.layouts_built
    first = AB._fragments(w, (384, 64))
    assert AB._fragments(w, (384, 64)) is first and AB.prenorm_linear_attention.layouts_built == built + 1
    with torch.no_grad():
        w.mul_(2)
    second = AB._fragments(w, (384, 64))
    assert AB.prenorm_linear_attention.layouts_built == built + 2
    assert torch.equal(second.float(), 2 * first.float())
