"""Flash cosine attention over (B, heads, d, N): the CUDA kernel and its plain version.

Per (batch, head), over q, k, v of shape (d, N):

    q'  = q / max(|q|, 1e-12),  k' = k / max(|k|, 1e-12)   each row's norm over N
    out = v softmax_keys(scale * q'^T k')^T

in fp32, output in q's dtype. The norms run over the spatial axis, as the
reference normalises its (b, h, d, n) layout over the last axis
(models/unet_model.py:21-23,234). Port of
``tedm_tpu/ops/pallas/flash_attention.py`` (``flash_cosine_attention``: the
Pallas ``_flash_kernel`` launched by ``_flash_pallas``, whose
``jax.custom_vjp`` backward differentiates ``cosine_attention_reference``).
On a CUDA tensor ``flash_cosine_attention`` launches the hand-written
Hopper kernels in ``csrc/flash_attention.cu`` (design and bound in that
file's header) through an ``autograd.Function`` whose backward
differentiates the plain version, as JAX's does; on a CPU tensor it runs
``cosine_attention_reference``, differentiated by autograd. The layout is
the Pallas kernel's (BH, d, N), with the batch and head axes apart.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tedm_tpu_torch.kernels import _build

D_HEAD = 32  # the kernel's compiled head width


def cosine_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, norm_dim: int = -1
) -> torch.Tensor:
    """Plain PyTorch version (the math of JAX's ``cosine_attention_reference``,
    flash_attention.py:137-154): q, k, v (B, h, d, N), out (B, h, d, N) in
    q's dtype. ``norm_dim`` is the axis of the norms, N; another axis is for
    checks that alter it."""
    qf = F.normalize(q.float(), dim=norm_dim, eps=1e-12) * scale
    kf = F.normalize(k.float(), dim=norm_dim, eps=1e-12)
    attn = torch.einsum("bhdi,bhdj->bhij", qf, kf).softmax(dim=-1)
    return torch.einsum("bhij,bhdj->bhdi", attn, v.float()).to(q.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    lib.fa_workspace_floats.argtypes = [ctypes.c_int] * 2
    lib.fa_workspace_floats.restype = ctypes.c_longlong
    lib.fa_forward.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_float] + [ctypes.c_void_p] * 3
    )
    lib.fa_forward.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in zip("qkv", (q, k, v)):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise TypeError(f"flash_cosine_attention CUDA kernel takes q, k, v of one dtype, fp32 or bf16; "
                            f"got {name}.dtype={t.dtype}, q.dtype={q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4 or t.shape != q.shape:
            raise ValueError(f"q, k, v must share one (B, h, d, N) shape, got {name}.shape={tuple(t.shape)}")
        _, _, d, n = t.shape
        if d != D_HEAD:
            raise ValueError(f"flash_cosine_attention CUDA kernel takes d={D_HEAD}, got d={d}")
        if t.stride()[1:] != (d * n, n, 1):
            raise ValueError(f"{name} must be contiguous within each batch element, got strides {t.stride()}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Launch the kernels: out (B, h, d, N) contiguous, in q's dtype."""
    _check(q, k, v)
    b, h, d, n = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        out = torch.empty((b, h, d, n), device=q.device, dtype=q.dtype)
        ws = torch.empty(lib.fa_workspace_floats(b, h), device=q.device, dtype=torch.float32)
        err = lib.fa_forward(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), b, h, n, float(scale), ws.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_cosine_attention kernel launch failed with CUDA error {err}")
    flash_cosine_attention.launches += 1
    return out


class _FlashCosineAttentionCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        # q, k, v are views of the qkv conv output, which stays alive anyway
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad[:3]) if need]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            out = cosine_attention_reference(*leaves, ctx.scale)
            grads = torch.autograd.grad(out, [leaves[i] for i in wanted], grad_out)
        result = [None] * 4
        for i, g in zip(wanted, grads):
            result[i] = g
        return tuple(result)


def flash_cosine_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Cosine-similarity attention over (B, heads, d, N) tensors, output
    (B, heads, d, N) in q's dtype.

    CUDA tensors (fp32 or bf16, d=32, contiguous within each batch element)
    go through the kernels, counted in ``flash_cosine_attention.launches``;
    the backward recomputes the plain version and launches nothing. CPU
    tensors go through ``cosine_attention_reference``.
    """
    if q.device.type == "cpu":
        return cosine_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_cosine_attention runs on cuda or cpu tensors, got {q.device}")
    return _FlashCosineAttentionCUDA.apply(q, k, v, float(scale))


flash_cosine_attention.launches = 0
