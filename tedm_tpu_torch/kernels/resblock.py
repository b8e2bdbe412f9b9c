"""The whole ResnetBlock: the CUDA kernel and its plain version.

Over x (B, Cin, H, W), the compute dtype that of x:

    h   = conv3x3(x, w1) + b1 -> GroupNorm8 -> FiLM -> SiLU
    h   = conv3x3(h, w2) + b2 -> GroupNorm8 -> SiLU
    out = h + (conv1x1(x, wres) + bres, or x when Cin == Cout)

Port of ``tedm_tpu/ops/pallas/resblock.py`` (``fused_resnet_block``: the
Pallas ``_kernel`` launched by ``_fwd_pallas``, whose ``jax.custom_vjp``
backward differentiates ``resnet_block_reference``). On a CUDA tensor
``fused_resnet_block`` launches the hand-written Hopper kernels in
``csrc/resblock.cu`` (design and bound in that file's header) through an
``autograd.Function`` whose backward differentiates the plain version, as
JAX's does; on a CPU tensor it runs ``resnet_block_reference``,
differentiated by autograd.

Weights come in the port's layout: ``w1`` (Cout, Cin, 3, 3), ``w2`` (Cout,
Cout, 3, 3), ``wres`` (Cout, Cin, 1, 1) or None, biases and GroupNorm
gains and shifts (Cout,), FiLM ``scale``/``shift`` (B, Cout) or None. They
stay fp32; a convolution in the compute dtype rounds both operands to it
and sums in fp32, as ``preferred_element_type=jnp.float32`` does. The
wrapper lays the weights out (Cin, taps, Cout) for the kernel on each call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from tedm_tpu_torch.kernels import _build
from tedm_tpu_torch.kernels.groupnorm import check_activation, film_rows, group_norm_film_silu_reference, group_stats


def resnet_block_reference(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, g1: torch.Tensor, be1: torch.Tensor,
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
    w2: torch.Tensor, b2: torch.Tensor, g2: torch.Tensor, be2: torch.Tensor,
    wres: Optional[torch.Tensor] = None, bres: Optional[torch.Tensor] = None,
    groups: int = 8, eps: float = 1e-5, pad_after_norm: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version, cast point by cast point the JAX
    ``resnet_block_reference`` (resblock.py:231-280) in NCHW: convolutions
    take operands in x's dtype and sum in fp32 (on the CPU, fp32
    convolutions of the rounded operands, since a CPU bf16 convolution
    rounds its output), the GroupNorm statistics run over the fp32 conv
    output, h is cast to x's dtype only before conv2, and the residual is
    added in fp32 and cast once. ``pad_after_norm`` is a control for checks:
    conv2 then pads h after GN1+SiLU, so its border reads SiLU(GN1(0))
    instead of 0."""
    cdt = x.dtype

    def rounded(t: torch.Tensor) -> torch.Tensor:  # an operand of a product in cdt
        return t.to(cdt).float()

    def col(t: torch.Tensor) -> torch.Tensor:
        return t.float().reshape(1, -1, 1, 1)

    h = F.conv2d(rounded(x), rounded(w1), padding=1) + col(b1)
    if pad_after_norm:
        h = group_norm_film_silu_reference(F.pad(h, (1, 1, 1, 1)), g1, be1, scale, shift, groups, eps,
                                           stats=group_stats(h, groups, eps))
        h = F.conv2d(rounded(h), rounded(w2)) + col(b2)
    else:
        h = group_norm_film_silu_reference(h, g1, be1, scale, shift, groups, eps)
        h = F.conv2d(rounded(h), rounded(w2), padding=1) + col(b2)
    h = group_norm_film_silu_reference(h, g2, be2, None, None, groups, eps)
    res = x.float() if wres is None else F.conv2d(rounded(x), rounded(wres)) + col(bres)
    return (h + res).to(cdt)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("resblock")
    lib.rb_workspace_floats.argtypes = [ctypes.c_int] * 4
    lib.rb_workspace_floats.restype = ctypes.c_longlong
    lib.rb_forward.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3
    )
    lib.rb_forward.restype = ctypes.c_int
    return lib


def _taps_layout(w: torch.Tensor, cout: int, cin: int, k: int, cdt: torch.dtype, x: torch.Tensor) -> torch.Tensor:
    """A (Cout, Cin, k, k) conv weight as the kernel reads it: (Cin, k*k,
    Cout) fp32, contiguous, holding values of the compute dtype."""
    if w.shape != (cout, cin, k, k) or w.device != x.device:
        raise ValueError(f"a conv weight of shape {tuple(w.shape)} on {w.device}, expected "
                         f"{(cout, cin, k, k)} on {x.device}")
    return w.detach().to(cdt).float().permute(1, 2, 3, 0).reshape(cin, k * k, cout).contiguous()


def _forward(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, groups, eps) -> torch.Tensor:
    """Launch the kernels: out (B, Cout, H, W) in x's dtype, contiguous."""
    check_activation(x, "fused_resnet_block")
    b, cin, h, w = x.shape
    cout = w1.shape[0]
    if cout % groups or cout % 4:
        raise ValueError(f"Cout={cout} must be a multiple of groups={groups} and of 4")
    if wres is None and cin != cout:
        raise ValueError(f"the identity residual needs Cin == Cout, got {cin} and {cout}")
    cdt = x.dtype
    vec = [t.detach().float().reshape(cout).contiguous() for t in (b1, g1, be1, b2, g2, be2)]
    if any(t.device != x.device for t in vec):
        raise ValueError(f"biases and gains must be on {x.device}")
    w1t = _taps_layout(w1, cout, cin, 3, cdt, x)
    w2t = _taps_layout(w2, cout, cout, 3, cdt, x)
    wrest = None if wres is None else _taps_layout(wres, cout, cin, 1, cdt, x)
    brest = None if wres is None else bres.detach().float().reshape(cout).contiguous()
    scale, shift, film_stride, film_bf16 = film_rows(scale, shift, x, cout)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty((b, cout, h, w), device=x.device, dtype=cdt)
        ws = torch.empty(lib.rb_workspace_floats(b, cout, h, w), device=x.device, dtype=torch.float32)
        err = lib.rb_forward(
            int(cdt == torch.bfloat16), int(film_bf16), x.data_ptr(), x.stride(0), b, cin, cout, h, w,
            w1t.data_ptr(), vec[0].data_ptr(), vec[1].data_ptr(), vec[2].data_ptr(), ptr(scale), ptr(shift),
            film_stride, w2t.data_ptr(), vec[3].data_ptr(), vec[4].data_ptr(), vec[5].data_ptr(),
            ptr(wrest), ptr(brest), groups, float(eps), ws.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_resnet_block kernel launch failed with CUDA error {err}")
    fused_resnet_block.launches += 1
    return out


class _ResnetBlockCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, groups, eps):
        # x and the weights only, as the JAX _block_fwd keeps them
        ctx.save_for_backward(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres)
        ctx.groups, ctx.eps = groups, eps
        return _forward(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, groups, eps)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[:13]) if need]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            out = resnet_block_reference(*leaves, groups=ctx.groups, eps=ctx.eps)
            grads = torch.autograd.grad(out, [leaves[i] for i in wanted], grad_out)
        result = [None] * 15
        for i, g in zip(wanted, grads):
            result[i] = g
        return tuple(result)


def fused_resnet_block(
    x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, g1: torch.Tensor, be1: torch.Tensor,
    scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
    w2: torch.Tensor, b2: torch.Tensor, g2: torch.Tensor, be2: torch.Tensor,
    wres: Optional[torch.Tensor] = None, bres: Optional[torch.Tensor] = None,
    groups: int = 8, eps: float = 1e-5,
) -> torch.Tensor:
    """conv3x3 -> GN+FiLM+SiLU -> conv3x3 -> GN+SiLU -> + residual over x
    (B, Cin, H, W); output (B, Cout, H, W) in x's dtype.

    CUDA tensors (fp32 or bf16, contiguous within each batch element, Cout
    a multiple of ``groups`` and of 4) go through the kernels, counted in
    ``fused_resnet_block.launches``; the backward recomputes the plain
    version and launches nothing. CPU tensors go through
    ``resnet_block_reference``.
    """
    args = (x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres)
    if x.device.type == "cpu":
        return resnet_block_reference(*args, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resnet_block runs on cuda or cpu tensors, got {x.device}")
    return _ResnetBlockCUDA.apply(*args, groups, float(eps))


fused_resnet_block.launches = 0
