"""Linear attention over (B, heads, d, N): the CUDA kernels and their plain versions.

Per (batch, head), over q, k, v of shape (d, N):

    s   = softmax_d(q) * scale
    p   = softmax_N(k)
    C   = p (v / N)^T
    out = C^T s

Port of ``tedm_tpu/ops/pallas/linear_attention.py`` (``linear_attention``:
the Pallas forward ``_fwd_kernel`` and the analytic backward ``_bwd_kernel``
behind its ``jax.custom_vjp``); the reference math is
models/unet_model.py:178-210. On a CUDA tensor ``linear_attention``
launches the hand-written Hopper kernels in ``csrc/linear_attention.cu``
(design and bound in that file's header) through an ``autograd.Function``
whose backward is a kernel too, or raises; on a CPU tensor it runs
``linear_attention_reference``, differentiated by autograd.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from tedm_tpu_torch.kernels import _build

D_HEAD = 32  # the kernel's compiled head width


def linear_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Plain PyTorch version (same math as tedm_tpu/models/unet.py:387-395):
    q, k, v (B, h, d, N); fp32 math, output in q's dtype."""
    n = q.shape[-1]
    qf = torch.softmax(q.float(), dim=2) * scale
    kf = torch.softmax(k.float(), dim=3)
    vf = v.float() / n
    ctx = torch.einsum("bhdn,bhen->bhde", kf, vf)
    return torch.einsum("bhde,bhdn->bhen", ctx, qf).to(q.dtype)


def linear_attention_backward_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain analytic VJP of ``linear_attention_reference`` for the output
    gradient g: (dq, dk, dv), the same math as the Pallas ``_bwd_kernel``
    (tedm_tpu/ops/pallas/linear_attention.py:72-110), fp32."""
    n = q.shape[-1]
    s = torch.softmax(q.float(), dim=2)
    p = torch.softmax(k.float(), dim=3)
    vf = v.float() / n
    g = g.float()
    ctx = torch.einsum("bhdn,bhen->bhde", p, vf)
    ds = torch.einsum("bhde,bhen->bhdn", ctx, g) * scale
    dq = s * (ds - (s * ds).sum(dim=2, keepdim=True))
    dctx = torch.einsum("bhdn,bhen->bhde", s * scale, g)
    dv = torch.einsum("bhde,bhdn->bhen", dctx, p) / n
    dp = torch.einsum("bhde,bhen->bhdn", dctx, vf)
    dk = p * (dp - (p * dp).sum(dim=3, keepdim=True))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("linear_attention")
    for fn in (lib.la_workspace_floats, lib.la_backward_workspace_floats):
        fn.argtypes = [ctypes.c_int, ctypes.c_int]
        fn.restype = ctypes.c_longlong
    lib.la_forward_f32.argtypes = (
        [ctypes.c_void_p] * 7
        + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.la_forward_f32.restype = ctypes.c_int
    lib.la_backward_f32.argtypes = (
        [ctypes.c_void_p] * 10
        + [ctypes.c_longlong] * 4
        + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.la_backward_f32.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, *others: torch.Tensor) -> None:
    for name, t in zip("qkvg", (q, *others)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"linear_attention CUDA kernel takes float32, got {name}.dtype={t.dtype}: "
                "a bf16 block runs as one fused block, kernels.attn_block.prenorm_linear_attention, "
                "as in the JAX package"
            )
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"q, k, v must share one (B, h, d, N) shape, got {name}.shape={tuple(t.shape)}")
        _, _, d, n = t.shape
        if d != D_HEAD:
            raise ValueError(f"linear_attention CUDA kernel takes d={D_HEAD}, got d={d}")
        if t.stride()[1:] != (d * n, n, 1):
            raise ValueError(
                f"{name} must be contiguous within each batch element, got strides {t.stride()}"
            )


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"linear_attention {what} kernel launch failed with CUDA error {err}")


def _forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel: (out, scale*C (B*h, d, d), stats (B*h, 2, d))."""
    _check(q, k, v)
    b, h, d, n = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        empty = functools.partial(torch.empty, device=q.device, dtype=torch.float32)
        out, ctx, stats = empty((b, h, d, n)), empty((b * h, d, d)), empty((b * h, 2, d))
        ws = empty(lib.la_workspace_floats(b * h, n))
        err = lib.la_forward_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctx.data_ptr(),
            stats.data_ptr(), ws.data_ptr(), q.stride(0), k.stride(0), v.stride(0), b, h, n,
            float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "forward")
    linear_attention.launches += 1
    return out, ctx, stats


def _backward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    ctx: torch.Tensor, stats: torch.Tensor, scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernel on the forward's ``ctx`` and ``stats``:
    (dq, dk, dv), each (B, h, d, N) contiguous."""
    b, h, d, n = q.shape
    if g.shape == q.shape and g.stride()[1:] != (d * n, n, 1):
        g = g.contiguous()  # autograd may hand over any layout
    _check(q, k, v, g)
    if ctx.shape != (b * h, d, d) or stats.shape != (b * h, 2, d) or not (
        ctx.is_contiguous() and stats.is_contiguous()
    ):
        raise ValueError("ctx and stats must be the forward's outputs for these q, k, v")
    lib = _library()
    with torch.cuda.device(q.device):
        empty = functools.partial(torch.empty, device=q.device, dtype=torch.float32)
        dq, dk, dv = empty((b, h, d, n)), empty((b, h, d, n)), empty((b, h, d, n))
        ws = empty(lib.la_backward_workspace_floats(b * h, n))
        err = lib.la_backward_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), ctx.data_ptr(),
            stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), g.stride(0), b, h, n, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, "backward")
    linear_attention.backward_launches += 1
    return dq, dk, dv


class _LinearAttentionCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, c, stats = _forward(q, k, v, scale)
        # the context and softmax_N statistics are B*h*(d*d + 2*d) floats;
        # q, k, v are views of the qkv conv output, which stays alive anyway
        ctx.save_for_backward(q, k, v, c, stats)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        q, k, v, c, stats = ctx.saved_tensors
        return (*_backward(q, k, v, grad_out, c, stats, ctx.scale), None)


def linear_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Linear attention over (B, heads, d, N) tensors, output (B, heads, d, N).

    CUDA tensors (float32, d=32, contiguous within each batch element) go
    through the kernels, counted in ``linear_attention.launches`` (forward)
    and ``linear_attention.backward_launches`` (backward); CPU tensors
    through ``linear_attention_reference``.
    """
    if q.device.type == "cpu":
        return linear_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"linear_attention runs on cuda or cpu tensors, got {q.device}")
    return _LinearAttentionCUDA.apply(q, k, v, float(scale))


linear_attention.launches = 0
linear_attention.backward_launches = 0
