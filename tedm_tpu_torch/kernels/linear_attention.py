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
``linear_attention_reference``, differentiated by autograd. The forward
kernel folds shares of the columns into online-softmax partials, merges them
in order and applies the context; the backward kernel runs as two passes,
one over q and g and one over k and v. ``linear_attention_forward_passes``
and ``linear_attention_backward_passes`` are their plain versions, pass by
pass, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
from torch.autograd.function import once_differentiable

from tedm_tpu_torch.kernels import _build
from tedm_tpu_torch.kernels.tf32 import split_matmul, tf32_split

D_HEAD = 32  # the kernel's compiled head width
FW = 16      # columns of a warp's slice of a tile in the forward kernel (csrc: FW)
FWARPS = 8   # warps of a forward block (csrc: FWARPS)


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


def linear_attention_saved_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel saves for the backward, in plain PyTorch:
    scale*C (B*h, d, d), C = softmax_N(k) (v / N)^T, and the statistics
    (B*h, 2, d) of softmax_N(k), its row max m and the sum l of exp(k - m).
    Takes ``_forward``'s arguments; q is not read."""
    b, h, d, n = k.shape
    kf = k.float()
    m = kf.amax(dim=3)
    e = torch.exp(kf - m[..., None])
    l = e.sum(dim=3)
    ctx = torch.einsum("bhdn,bhen->bhde", e / l[..., None], v.float() / n) * scale
    return ctx.reshape(b * h, d, d), torch.stack([m, l], dim=2).reshape(b * h, 2, d)


def _fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c, as the kernel's fmaf: the product exact in fp64, one
    rounding to fp32 after the sum."""
    return (a.double() * b.double() + c.double()).float()


def _warp_context(
    kf: torch.Tensor, vf: torch.Tensor, slices: list, tf32: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward warp's online softmax over its ``slices`` ((s0, s1)
    column ranges, in order), as the kernel's ``context_tiles`` folds them:
    per slice the new row max m of k, e = exp(k - m), the factor f =
    exp(m_old - m), l = fmaf(l, f, sum_c e) (summed column by column) and
    P = fmaf(P, f, E V^T), the slice's product from 0. ``tf32``: that product
    in split TF32, the warp's first column by an fmaf instead, so that e = 1
    on one column gives v exactly. Returns (m, l, P), -inf, 0 and 0 for a
    warp with no slice."""
    b, h, d, _ = kf.shape
    m = torch.full((b, h, d), -torch.inf)
    l, p = torch.zeros(b, h, d), torch.zeros(b, h, d, d)
    for i, (s0, s1) in enumerate(slices):
        x, sv = kf[..., s0:s1], vf[..., s0:s1]
        m_new = torch.maximum(m, x.amax(dim=3))
        f = torch.exp(m - m_new)
        e = torch.exp(x - m_new[..., None])
        total = e[..., 0]
        for c in range(1, s1 - s0):
            total = total + e[..., c]
        l = _fmaf(l, f, total)
        vt = sv.transpose(-1, -2)
        if not tf32:
            add = e @ vt
        elif i > 0:
            add = split_matmul(e, vt)
        else:
            add = _fmaf(e[..., :1], vt[..., :1, :], split_matmul(e[..., 1:], vt[..., 1:, :]))
        p = _fmaf(p, f[..., None], add)
        m = m_new
    return m, l, p


def _merge_parts(parts: list) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partials (m, l, P) merged in order, as the kernel's ``merge_parts``:
    m = max_c m_c, f_c = exp(m_c - m) (0 for a partial of no columns), l and
    P fmaf chains in c."""
    m = torch.stack([part[0] for part in parts]).amax(dim=0)
    l, p = torch.zeros_like(m), torch.zeros(*m.shape, m.shape[-1])
    for mc, lc, pc in parts:
        f = torch.where(mc == -torch.inf, 0.0, torch.exp(mc - m))
        l = _fmaf(lc, f, l)
        p = _fmaf(pc, f[..., None], p)
    return m, l, p


def linear_attention_forward_passes(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, chunk: int, tf32: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's passes in plain PyTorch: the N columns of each
    (b, h) cut into shares of ``chunk``, one a block; a block's tiles of
    ``FW * FWARPS`` columns from the share's start, warp w taking columns
    ``w * FW ..`` of each, its slices folded into its own online-softmax
    partial (``_warp_context``); the warps' partials merged in warp order,
    the shares' in share order (``_merge_parts``), into scale*C = P (scale /
    (l N)) and the statistics (m, l); then out = (scale C)^T softmax_d(q).
    Returns (out, scale*C (B*h, d, d), stats (B*h, 2, d)), as ``_forward``
    does, fp32. ``tf32``: P and out as the kernel's split-TF32 products,
    each warp's first column by an fmaf."""
    b, h, d, n = k.shape
    kf, vf = k.float(), v.float()
    shares = []
    for start in range(0, n, chunk):
        end = min(start + chunk, n)
        warps = [_warp_context(kf, vf, [(c0, min(c0 + FW, end)) for c0 in range(start + w * FW, end, FW * FWARPS)],
                               tf32) for w in range(FWARPS)]
        shares.append(_merge_parts(warps))
    m, l, p = _merge_parts(shares)
    ctx = p * (scale / (l * n))[..., None]
    s = torch.softmax(q.float(), dim=2)
    ct = ctx.transpose(2, 3)
    out = split_matmul(ct, s) if tf32 else ct @ s
    return out.to(q.dtype), ctx.reshape(b * h, d, d), torch.stack([m, l], dim=2).reshape(b * h, 2, d)


def _chain(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """a @ b over the last two dims, summed one k at a time in ascending
    order: every output row is computed alike from its row of a, as the
    kernel's tensor-core products and fmaf chains compute it. ``tf32``: each
    term as the split-TF32 route's three products."""
    if tf32:
        (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
        term = lambda k: (al[..., k:k + 1] * bh[..., k:k + 1, :] + ah[..., k:k + 1] * bl[..., k:k + 1, :]
                          + ah[..., k:k + 1] * bh[..., k:k + 1, :])
    else:
        term = lambda k: a[..., k:k + 1] * b[..., k:k + 1, :]
    out = term(0)
    for k in range(1, a.shape[-1]):
        out = out + term(k)
    return out


def linear_attention_backward_pass_q(
    q: torch.Tensor, g: torch.Tensor, ctx: torch.Tensor, tf32: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's first pass in plain PyTorch, from what it reads:
    q and g (B, h, d, N) and the forward's scale*C (B*h, d, d). Returns dq
    = s * (ds - sum_d s*ds) with s = softmax_d(q) and ds = (scale C) g, dC'
    = s g^T (B*h, d, d) and r[d] = sum_e dC'[d, e] (scale C)[d, e] (B*h,
    d), fp32; r summed over e in order, as pass 2 sums dp. ``tf32``: ds and
    dC' in split TF32, as the kernel's tensor cores compute them."""
    b, h, d, n = q.shape
    s = torch.softmax(q.float(), dim=2)
    gf = g.float()
    c = ctx.float().reshape(b, h, d, d)
    ds = _chain(c, gf, tf32)
    dq = s * (ds - (s * ds).sum(dim=2, keepdim=True))
    gt = gf.transpose(2, 3)
    dctx = split_matmul(s, gt) if tf32 else s @ gt
    r = _chain(dctx.unsqueeze(3), c.unsqueeze(4)).reshape(b, h, d)  # row d: sum_e dC'[d, e] c[d, e]
    return dq.to(q.dtype), dctx.reshape(b * h, d, d), r.reshape(b * h, d)


def linear_attention_backward_pass_kv(
    k: torch.Tensor, v: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
    dctx: torch.Tensor, r: torch.Tensor, scale: float, tf32: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's second pass in plain PyTorch, from what it
    reads: k and v (B, h, d, N), the forward's softmax_N statistics m and l
    (B*h, d) and the first pass's dC' and r. Returns dk = p * (dp - r) and
    dv = (scale / N) dC'^T p, with p = exp(k - m) / l and dp = dC' w, w =
    (scale / N) v, summed over e in order as pass 1 sums r, fp32. Where dp =
    r in exact arithmetic (N = 1, where dk vanishes) the two are equal here
    too. ``tf32``: dv in split TF32, as the kernel's tensor cores compute
    it; dp is an fp32 chain on the CUDA cores."""
    b, h, d, n = k.shape
    p = torch.exp(k.float() - m.reshape(b, h, d, 1)) * (1.0 / l.reshape(b, h, d, 1))
    dc = dctx.float().reshape(b, h, d, d)
    coef = scale / n
    dv = _chain(dc.transpose(2, 3), p, tf32) * coef
    dp = _chain(dc, v.float() * coef)
    dk = p * (dp - r.reshape(b, h, d, 1))
    return dk.to(k.dtype), dv.to(v.dtype)


def linear_attention_backward_passes(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
    ctx: torch.Tensor, stats: torch.Tensor, scale: float, tf32: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the backward kernel's two passes in plain PyTorch,
    from the forward's saved scale*C and statistics
    (``linear_attention_saved_reference``)."""
    dq, dctx, r = linear_attention_backward_pass_q(q, g, ctx, tf32)
    dk, dv = linear_attention_backward_pass_kv(k, v, stats[:, 0], stats[:, 1], dctx, r, scale, tf32)
    return dq, dk, dv


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("linear_attention")
    lib.la_forward_route.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_forward_route.restype = ctypes.c_int
    lib.la_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_workspace_floats.restype = ctypes.c_longlong
    lib.la_backward_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_backward_workspace_floats.restype = ctypes.c_longlong
    lib.la_forward_f32.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_longlong] * 3
        + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p]
    )
    lib.la_forward_f32.restype = ctypes.c_int
    lib.la_backward_f32.argtypes = (
        [ctypes.c_void_p] * 11
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


_arrivals: Dict[Tuple[int, int], torch.Tensor] = {}


def _arrival_counts(device: torch.device, stream: int, bh: int) -> torch.Tensor:
    """The per-(b, h) arrival counters of the kernels' last-block merges
    (the forward's two-launch route, the backward) for this device and
    stream: zero before each call, and left zero by it (its last block of
    each (b, h) resets its counter), so no call clears them; calls on one
    stream run one after the other. Made (or grown) once."""
    counts = _arrivals.get((device.index, stream))
    if counts is None or counts.numel() < bh:
        counts = _arrivals[(device.index, stream)] = torch.zeros(bh, device=device, dtype=torch.int32)
    return counts


def forward_route(bh: int, n: int) -> int:
    """The forward kernel's route for B*h = bh and N = n
    (``csrc/linear_attention.cu`` ``forward_route``): the cluster size of
    its one-launch route, or 0 for its two launches."""
    return _library().la_forward_route(bh, n)


def _forward(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the forward kernel on its route (``forward_route``): (out,
    scale*C (B*h, d, d), stats (B*h, 2, d))."""
    _check(q, k, v)
    b, h, d, n = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        empty = functools.partial(torch.empty, device=q.device, dtype=torch.float32)
        out, ctx, stats = empty((b, h, d, n)), empty((b * h, d, d)), empty((b * h, 2, d))
        ws = empty(lib.la_workspace_floats(b * h, n))
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.la_forward_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctx.data_ptr(),
            stats.data_ptr(), ws.data_ptr(), _arrival_counts(q.device, stream, b * h).data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), b, h, n, float(scale), stream,
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
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.la_backward_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), ctx.data_ptr(),
            stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
            _arrival_counts(q.device, stream, b * h).data_ptr(),
            q.stride(0), k.stride(0), v.stride(0), g.stride(0), b, h, n, float(scale), stream,
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
