"""The fused Residual(PreNorm(LinearAttention)) block: the CUDA kernel and its plain version.

Over x of shape (B, C, N), the (B, C, H*W) view of an NCHW activation:

    y    = ChanLayerNorm_in(x)                 fp32 statistics, cast to the compute dtype
    qkv  = W_qkv y                             fp32 accumulation, kept fp32
    ctx  = per head: exp(k - max_N k) v^T / (sum_N exp(k - max_N k) * N)
    attn = per head: ctx^T (softmax_d(q) * scale)
    o    = W_out attn + b_out                  fp32 accumulation
    out  = ChanLayerNorm_out(o) + x            cast to x's dtype

Port of ``tedm_tpu/ops/pallas/attn_block.py`` (``prenorm_linear_attention``:
the Pallas ``_kernel`` launched by ``_fwd_pallas``). The JAX package runs it
in bf16 only: an fp32 ``PreNormAttn`` on a TPU never fuses and takes the
linear-attention kernel (``kernels/linear_attention.py``) instead. On a CUDA
tensor ``prenorm_linear_attention`` launches the hand-written Hopper kernel
in ``csrc/attn_block.cu`` (bf16 only; design and bound in that file's
header) through an ``autograd.Function`` whose backward differentiates the
plain version, as the JAX VJP differentiates its jnp reference; on a CPU
tensor it runs ``prenorm_linear_attention_reference``, differentiated by
autograd.

Weights come in the port's conv layout: ``w_qkv`` (3*heads*dim_head, C[, 1,
1]), ``w_out`` (C, heads*dim_head[, 1, 1]), ``b_out`` (C,), the gains ``g_in``
and ``g_out`` (C,) or (1, C, 1, 1). They stay fp32; a product in the compute
dtype rounds both operands to it and sums in fp32, as
``preferred_element_type=jnp.float32`` does. The kernel reads the two
matrices in bf16 in the fragment order of its products
(``fragment_layout``), built once per weight version and storage
(``kernels/layouts.py``): once for a served model, once a step in training.
"""

from __future__ import annotations

import ctypes
import functools
import torch

from tedm_tpu_torch.kernels import _build, layouts, ops

HEADS, DIM_HEAD = 4, 32  # the kernel's compiled head layout, the UNet's only one
SCALE = DIM_HEAD ** -0.5
MAX_CHANNELS = 512       # the widest stage whose tiles fit in shared memory


def _cln(t: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """ChanLayerNorm over dim 1 of a (B, C, N) fp32 tensor: one-pass biased
    variance E[t^2] - mean^2 clamped at 0, eps 1e-5, gain only."""
    mean = t.mean(dim=1, keepdim=True)
    var = ((t * t).mean(dim=1, keepdim=True) - mean * mean).clamp(min=0.0)
    return (t - mean) * torch.rsqrt(var + 1e-5) * g.float().reshape(1, -1, 1)


def prenorm_linear_attention_reference(
    x: torch.Tensor, g_in: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
    b_out: torch.Tensor, g_out: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version, cast point by cast point the JAX
    ``prenorm_linear_attention_reference`` (attn_block.py:161-210) at its
    defaults (4 heads of 32, scale 32**-0.5) in the (B, C, N) layout; the
    compute dtype is x's."""
    b, c, n = x.shape
    hidden = HEADS * DIM_HEAD
    cdt = x.dtype

    def rounded(t: torch.Tensor) -> torch.Tensor:  # an operand of a product in cdt
        return t.to(cdt).float()

    xf = x.float()
    y = _cln(xf, g_in).to(cdt)
    qkv = torch.einsum("oc,bcn->bon", rounded(w_qkv.reshape(3 * hidden, c)), y.float())
    q, k, v = (t.reshape(b, HEADS, DIM_HEAD, n) for t in qkv.split(hidden, dim=1))

    kexp = torch.exp(k - k.amax(dim=3, keepdim=True))
    sk = kexp.sum(dim=3)                                          # (B, heads, d)
    ctx = torch.einsum("bhdn,bhen->bhde", rounded(kexp), rounded(v))
    ctx = ctx / (sk[..., None] * float(n))

    # softmax over d per head, less the max over every head's rows of the
    # position (a constant of the position, as the kernel takes it)
    qe = torch.exp(q - q.amax(dim=(1, 2), keepdim=True))
    qs = qe / qe.sum(dim=2, keepdim=True) * SCALE
    attn = torch.einsum("bhde,bhdn->bhen", rounded(ctx), rounded(qs)).reshape(b, hidden, n)
    o = torch.einsum("ch,bhn->bcn", rounded(w_out.reshape(c, hidden)), rounded(attn))
    o = o + b_out.float().reshape(1, c, 1)
    return (_cln(o, g_out) + xf).to(x.dtype)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("attn_block")
    lib.pla_workspace_floats.argtypes = [ctypes.c_int] * 3
    lib.pla_workspace_floats.restype = ctypes.c_longlong
    lib.pla_forward_bf16.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.pla_forward_bf16.restype = ctypes.c_int
    return lib


def fragment_layout(w: torch.Tensor) -> torch.Tensor:
    """A (M, K) weight, M and K multiples of 16, as the kernel's mma.sync
    m16n8k16 products read their A operand: bf16, per 16 x 16 tile (m-tile,
    k-tile) in that order, the 32 lanes' fragments, lane l = 4 g + t holding
    rows (g, g + 8) x columns (2t, 2t + 1, 2t + 8, 2t + 9) as a0 = (g, 2t..),
    a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..): one
    16-byte load a lane a fragment."""
    m, k = w.shape
    t = w.detach().to(torch.bfloat16).reshape(m // 16, 2, 8, k // 16, 2, 4, 2)  # (mt, r, g, kt, c, t, pair)
    return t.permute(0, 3, 2, 5, 4, 1, 6).contiguous()  # (mt, kt, g, t, c, r, pair): a_j, j = 2c + r


def _fragments(w: torch.Tensor, shape) -> torch.Tensor:
    """w's fragment layout, cached per weight version and storage
    (``layouts.cached_layout``), counted in
    ``prenorm_linear_attention.layouts_built``."""
    def build(t: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            prenorm_linear_attention.layouts_built += 1
            return fragment_layout(t.reshape(shape))
    return layouts.cached_layout(w, "mma.sync A fragments", build)


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(
            f"prenorm_linear_attention CUDA kernel takes bfloat16, got x.dtype={x.dtype} "
            "(an fp32 block takes the linear-attention kernel, as on the TPU)"
        )
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, N), got shape {tuple(x.shape)}")
    _, c, n = x.shape
    if c % 16 or not 16 <= c <= MAX_CHANNELS:
        raise ValueError(f"the kernel takes C a multiple of 16 up to {MAX_CHANNELS}, got C={c}")
    if x.stride()[1:] != (n, 1):
        raise ValueError(f"x must be contiguous within each batch element, got strides {x.stride()}")


def _weights(x, g_in, w_qkv, w_out, b_out, g_out):
    """The gains and bias as contiguous fp32 vectors, the two matrices in
    their fragment layouts, on x's device."""
    c = x.shape[1]
    hidden = HEADS * DIM_HEAD
    shapes = ((g_in, (c,)), (w_qkv, (3 * hidden, c)), (w_out, (c, hidden)), (b_out, (c,)), (g_out, (c,)))
    for t, shape in shapes:
        if t.device != x.device or t.numel() != torch.Size(shape).numel():
            raise ValueError(f"a weight of shape {tuple(t.shape)} on {t.device} for x on {x.device}, C={c}")
    vec = lambda t: t.detach().float().reshape(c).contiguous()
    return vec(g_in), _fragments(w_qkv, (3 * hidden, c)), _fragments(w_out, (c, hidden)), vec(b_out), vec(g_out)


def _forward(x, g_in, w_qkv, w_out, b_out, g_out) -> torch.Tensor:
    """Launch the kernel: out (B, C, N) bf16, contiguous."""
    _check(x)
    b, c, n = x.shape
    weights = _weights(x, g_in, w_qkv, w_out, b_out, g_out)
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty((b, c, n), device=x.device, dtype=torch.bfloat16)
        ws = torch.empty(lib.pla_workspace_floats(b, c, n), device=x.device, dtype=torch.float32)
        err = lib.pla_forward_bf16(
            x.data_ptr(), *(w.data_ptr() for w in weights), out.data_ptr(), ws.data_ptr(),
            x.stride(0), b, c, n, SCALE, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"prenorm_linear_attention kernel launch failed with CUDA error {err}")
    prenorm_linear_attention.launches += 1
    return out


class _PreNormLinearAttentionCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g_in, w_qkv, w_out, b_out, g_out):
        # x and the weights only, as the JAX _block_fwd keeps them
        ctx.save_for_backward(x, g_in, w_qkv, w_out, b_out, g_out)
        return ops.prenorm_linear_attention(x, g_in, w_qkv, w_out, b_out, g_out)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        wanted = [i for i, need in enumerate(ctx.needs_input_grad) if need]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            out = prenorm_linear_attention_reference(*leaves)
            grads = torch.autograd.grad(out, [leaves[i] for i in wanted], grad_out)
        result = [None] * 6
        for i, g in zip(wanted, grads):
            result[i] = g
        return tuple(result)


def prenorm_linear_attention(
    x: torch.Tensor, g_in: torch.Tensor, w_qkv: torch.Tensor, w_out: torch.Tensor,
    b_out: torch.Tensor, g_out: torch.Tensor,
) -> torch.Tensor:
    """The whole block over x (B, C, N), 4 heads of 32, scale 32**-0.5;
    output (B, C, N) in x's dtype.

    CUDA tensors (bf16, C a multiple of 16 up to 512, contiguous within each
    batch element) go through the kernel, counted in
    ``prenorm_linear_attention.launches``; its backward recomputes the plain
    version and launches nothing. CPU tensors go through
    ``prenorm_linear_attention_reference``. A call that autograd does not
    record is one call of the ``ops.prenorm_linear_attention`` op.
    """
    args = (x, g_in, w_qkv, w_out, b_out, g_out)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"prenorm_linear_attention runs on cuda or cpu tensors, got {x.device}")
    if not ops.needs_grad(*args):
        return ops.prenorm_linear_attention(*args)
    if x.device.type == "cpu":
        return prenorm_linear_attention_reference(*args)
    return _PreNormLinearAttentionCUDA.apply(*args)


prenorm_linear_attention.launches = 0
prenorm_linear_attention.layouts_built = 0  # fragment layouts of W_qkv and W_out built (_fragments)
