"""The kernel forwards as ``torch.library`` ops, namespace ``tedm_tpu_torch``.

Each kernel's forward is one op, so that a traced program holds it as one
node: ``torch.export`` writes it into an exported program, which then
launches the hand-written kernel on the card (``serve/export.py``), and a
CUDA graph captures its launches like any other (``serve/app.py``). Each op
has three implementations:

* CUDA: the kernel's launcher (``_forward`` of its module), which counts
  its launches in the wrapper's host counter, as the wrappers have always
  done;
* CPU: the kernel's plain version from the same module, the wrappers'
  device rule (a CUDA tensor never reaches it);
* fake: the output shapes and dtypes, for tracing, with no launch. What a
  route needs besides (B.1's workspace, B.3's route) stays inside the CUDA
  implementation.

| op | kernel | returns |
| --- | --- | --- |
| ``linear_attention`` | B.1 | ``(out, scale*C, stats)`` |
| ``prenorm_linear_attention`` | B.2 | the block's output |
| ``group_norm_film_silu`` | B.3 | its output |
| ``resnet_block`` | B.4 | ``(out, saved)``, ``saved`` as ``resblock.saved_views`` reads it |
| ``cosine_attention`` | B.5 | its output |

The wrappers (``linear_attention.linear_attention`` and the others) call
the op when autograd does not record through the call; when it does, the
``autograd.Function`` of the CUDA path calls it in its forward and keeps its
own backward, and the CPU path differentiates the plain version. Every
wrapper module imports this one, so the ops exist wherever a kernel can
run. The kernel modules are imported inside the implementations, which
keeps this module free of import cycles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

NAMESPACE = "tedm_tpu_torch"


def needs_grad(*tensors: Optional[Tensor]) -> bool:
    """Whether autograd records through a call on these tensors."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


# ---------------------------------------------------------------- B.1

@torch.library.custom_op(f"{NAMESPACE}::linear_attention", mutates_args=(), device_types="cuda")
def linear_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tuple[Tensor, Tensor, Tensor]:
    """B.1 over q, k, v (B, h, d, N): (out (B, h, d, N), scale*C (B*h, d, d),
    stats (B*h, 2, d))."""
    from tedm_tpu_torch.kernels import linear_attention as la

    return la._forward(q, k, v, scale)


@linear_attention.register_kernel("cpu")
def _(q, k, v, scale):
    from tedm_tpu_torch.kernels import linear_attention as la

    ctx, stats = la.linear_attention_saved_reference(q, k, v, scale)
    return la.linear_attention_reference(q, k, v, scale).contiguous(), ctx.contiguous(), stats.contiguous()


@linear_attention.register_fake
def _(q, k, v, scale):
    b, h, d, n = q.shape
    f32 = torch.float32
    return q.new_empty((b, h, d, n)), q.new_empty((b * h, d, d), dtype=f32), q.new_empty((b * h, 2, d), dtype=f32)


# ---------------------------------------------------------------- B.2

@torch.library.custom_op(f"{NAMESPACE}::prenorm_linear_attention", mutates_args=(), device_types="cuda")
def prenorm_linear_attention(
    x: Tensor, g_in: Tensor, w_qkv: Tensor, w_out: Tensor, b_out: Tensor, g_out: Tensor
) -> Tensor:
    """B.2 over x (B, C, N): the block's output (B, C, N)."""
    from tedm_tpu_torch.kernels import attn_block

    return attn_block._forward(x, g_in, w_qkv, w_out, b_out, g_out)


@prenorm_linear_attention.register_kernel("cpu")
def _(x, g_in, w_qkv, w_out, b_out, g_out):
    from tedm_tpu_torch.kernels import attn_block

    return attn_block.prenorm_linear_attention_reference(x, g_in, w_qkv, w_out, b_out, g_out).contiguous()


@prenorm_linear_attention.register_fake
def _(x, g_in, w_qkv, w_out, b_out, g_out):
    return x.new_empty(x.shape)


# ---------------------------------------------------------------- B.3

@torch.library.custom_op(f"{NAMESPACE}::group_norm_film_silu", mutates_args=(), device_types="cuda")
def group_norm_film_silu(
    x: Tensor, gamma: Tensor, beta: Tensor, scale: Optional[Tensor], shift: Optional[Tensor],
    groups: int, eps: float,
) -> Tensor:
    """B.3 over x (B, C, H, W): its output (B, C, H, W)."""
    from tedm_tpu_torch.kernels import groupnorm

    return groupnorm._forward(x, gamma, beta, scale, shift, groups, eps)


@group_norm_film_silu.register_kernel("cpu")
def _(x, gamma, beta, scale, shift, groups, eps):
    from tedm_tpu_torch.kernels import groupnorm

    return groupnorm.group_norm_film_silu_reference(x, gamma, beta, scale, shift, groups, eps).contiguous()


@group_norm_film_silu.register_fake
def _(x, gamma, beta, scale, shift, groups, eps):
    return x.new_empty(x.shape)


# ---------------------------------------------------------------- B.4

def resnet_block_saved_floats(b: int, c: int, h: int, w: int, groups: int) -> int:
    """Floats of B.4's ``saved`` (csrc/resblock.cu ``rb_saved_floats``): two
    affines (B, C, 2), two group statistics (B, groups, 2), h1 and h2."""
    return 4 * b * c + 4 * b * groups + 2 * b * c * h * w


@torch.library.custom_op(f"{NAMESPACE}::resnet_block", mutates_args=(), device_types="cuda")
def resnet_block(
    x: Tensor, w1: Tensor, b1: Tensor, g1: Tensor, be1: Tensor, scale: Optional[Tensor],
    shift: Optional[Tensor], w2: Tensor, b2: Tensor, g2: Tensor, be2: Tensor, wres: Optional[Tensor],
    bres: Optional[Tensor], groups: int, eps: float,
) -> Tuple[Tensor, Tensor]:
    """B.4 over x (B, Cin, H, W): (out (B, Cout, H, W), saved)."""
    from tedm_tpu_torch.kernels import resblock

    return resblock._forward(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, groups, eps)


@resnet_block.register_kernel("cpu")
def _(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, groups, eps):
    from tedm_tpu_torch.kernels import resblock

    return resblock.resnet_block_forward_reference(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres,
                                                   groups=groups, eps=eps)


@resnet_block.register_fake
def _(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, groups, eps):
    b, _, h, w = x.shape
    cout = w1.shape[0]
    return (x.new_empty((b, cout, h, w)),
            x.new_empty((resnet_block_saved_floats(b, cout, h, w, groups),), dtype=torch.float32))


# ---------------------------------------------------------------- B.5

@torch.library.custom_op(f"{NAMESPACE}::cosine_attention", mutates_args=(), device_types="cuda")
def cosine_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """B.5 over q, k, v (B, h, d, N): its output (B, h, d, N)."""
    from tedm_tpu_torch.kernels import flash_attention

    return flash_attention._forward(q, k, v, scale)


@cosine_attention.register_kernel("cpu")
def _(q, k, v, scale):
    from tedm_tpu_torch.kernels import flash_attention

    return flash_attention.cosine_attention_reference(q, k, v, scale).contiguous()


@cosine_attention.register_fake
def _(q, k, v, scale):
    return q.new_empty(q.shape)


OPS = {"B.1": linear_attention, "B.2": prenorm_linear_attention, "B.3": group_norm_film_silu,
       "B.4": resnet_block, "B.5": cosine_attention}
