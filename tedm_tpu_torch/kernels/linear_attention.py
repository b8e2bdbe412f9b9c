"""Linear attention over (B, heads, d, N): the CUDA kernel and its plain version.

Per (batch, head), over q, k, v of shape (d, N):

    s   = softmax_d(q) * scale
    p   = softmax_N(k)
    C   = p (v / N)^T
    out = C^T s

Port of ``tedm_tpu/ops/pallas/linear_attention.py`` (``linear_attention``,
the Pallas forward ``_fwd_kernel``); the reference math is
models/unet_model.py:178-210. On a CUDA tensor ``linear_attention``
launches the hand-written Hopper kernel in ``csrc/linear_attention.cu``
(design and bound in that file's header) or raises; on a CPU tensor it runs
``linear_attention_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tedm_tpu_torch.kernels import _build

D_HEAD = 32  # the kernel's compiled head width

_BACKWARD_TODO = (
    "linear_attention has no CUDA backward yet: the port of the Pallas "
    "_bwd_kernel (tedm_tpu/ops/pallas/linear_attention.py:72) is ROADMAP "
    "item B.1b, part of the training slice"
)


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


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("linear_attention")
    lib.la_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_workspace_floats.restype = ctypes.c_longlong
    lib.la_forward_f32.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.la_forward_f32.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"linear_attention CUDA kernel takes float32, got {name}.dtype={t.dtype} "
                "(bf16 comes with the bf16 serving slice)"
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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    _check(q, k, v)
    b, h, d, n = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        out = torch.empty((b, h, d, n), device=q.device, dtype=torch.float32)
        ws = torch.empty(lib.la_workspace_floats(b * h, n), device=q.device, dtype=torch.float32)
        err = lib.la_forward_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ws.data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), b, h, n, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"linear_attention kernel launch failed with CUDA error {err}")
    linear_attention.launches += 1
    return out


class _LinearAttentionCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(_BACKWARD_TODO)


def linear_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> torch.Tensor:
    """Linear attention over (B, heads, d, N) tensors, output (B, heads, d, N).

    CUDA tensors (float32, d=32, contiguous within each batch element) go
    through the kernel, counted in ``linear_attention.launches``; CPU
    tensors through ``linear_attention_reference``.
    """
    if q.device.type == "cpu":
        return linear_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"linear_attention runs on cuda or cpu tensors, got {q.device}")
    return _LinearAttentionCUDA.apply(q, k, v, float(scale))


linear_attention.launches = 0
