"""GroupNorm -> FiLM -> SiLU: the CUDA kernel and its plain version.

Over x (B, C, H, W), the port's NCHW layout (a group's channels are
contiguous there):

    out = SiLU((GroupNorm(x) * gamma + beta) * (scale + 1) + shift)

with fp32 statistics (the one-pass variance E[x^2] - mean^2 clamped at 0),
output in x's dtype. Port of ``tedm_tpu/ops/pallas/groupnorm.py``
(``fused_group_norm_film_silu``: the Pallas ``_gn_kernel`` launched by
``_fwd_pallas``, and the analytic VJP ``_bwd_jnp`` behind its
``jax.custom_vjp``). On a CUDA tensor ``fused_group_norm_film_silu``
launches the hand-written Hopper kernel in ``csrc/groupnorm.cu`` (design
and bound in that file's header) through an ``autograd.Function`` whose
backward is the plain analytic VJP, as JAX's is plain jnp; on a CPU tensor
it runs ``group_norm_film_silu_reference``, differentiated by autograd. The
UNet's default path (no ``--use_pallas_groupnorm``) runs the plain version
on every device. ``gn_route`` picks the kernel's route from the shape: one
cluster launch that reads x once, or, for a slab no cluster holds, two
passes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tedm_tpu_torch.kernels import _build

Stats = Tuple[torch.Tensor, torch.Tensor]


def group_stats(x: torch.Tensor, groups: int = 8, eps: float = 1e-5) -> Stats:
    """(mean, rstd) of each (batch, group) of x (B, C, H, W), each (B,
    groups, 1), fp32, with the one-pass variance clamped at 0."""
    xf = x.float().reshape(x.shape[0], groups, -1)
    mean = xf.mean(dim=2, keepdim=True)
    ex2 = (xf * xf).mean(dim=2, keepdim=True)
    return mean, torch.rsqrt(torch.clamp(ex2 - mean * mean, min=0.0) + eps)


def group_norm_film_silu_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    groups: int = 8,
    eps: float = 1e-5,
    stats: Optional[Stats] = None,
) -> torch.Tensor:
    """Plain PyTorch version (the math of the JAX reference,
    tedm_tpu/ops/pallas/groupnorm.py:172-189): x (B, C, H, W); gamma, beta
    (C,); scale, shift (B, C) or None. ``stats`` replaces x's own group
    statistics, for checks that alter them."""
    b, c, h, w = x.shape
    mean, rstd = group_stats(x, groups, eps) if stats is None else stats
    xhat = ((x.float().reshape(b, groups, -1) - mean) * rstd).reshape(b, c, h, w)
    f = xhat * gamma.float()[:, None, None] + beta.float()[:, None, None]
    if scale is not None:
        f = f * (scale.float()[:, :, None, None] + 1.0)
    if shift is not None:
        f = f + shift.float()[:, :, None, None]
    return F.silu(f).to(x.dtype)


def group_norm_film_silu_backward_reference(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    scale: Optional[torch.Tensor],
    shift: Optional[torch.Tensor],
    g: torch.Tensor,
    groups: int = 8,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The analytic VJP for the output gradient g, as JAX's ``_bwd_jnp``
    (groupnorm.py:192-228), in fp32: (dx, dgamma, dbeta, dscale, dshift),
    each in its input's dtype; dscale and dshift None where scale and shift
    are."""
    b, c, h, w = x.shape
    n, cg = h * w, c // groups
    mean, rstd = group_stats(x, groups, eps)
    xhat = ((x.float().reshape(b, groups, -1) - mean) * rstd).reshape(b, c, n)
    gammaf = gamma.float()[:, None]
    film = 1.0 if scale is None else scale.float()[:, :, None] + 1.0          # (B, C, 1)
    gn = xhat * gammaf + beta.float()[:, None]
    f = gn * film + (0.0 if shift is None else shift.float()[:, :, None])
    sig = torch.sigmoid(f)
    df = g.float().reshape(b, c, n) * sig * (1.0 + f * (1.0 - sig))          # SiLU VJP
    dgn = df * film
    dxhat = (dgn * gammaf).reshape(b, groups, cg * n)
    xg = xhat.reshape(b, groups, cg * n)
    m1 = dxhat.mean(dim=2, keepdim=True)
    m2 = (dxhat * xg).mean(dim=2, keepdim=True)
    dx = rstd * (dxhat - m1 - xg * m2)
    return (
        dx.reshape(b, c, h, w).to(x.dtype),
        (dgn * xhat).sum(dim=(0, 2)).to(gamma.dtype),
        dgn.sum(dim=(0, 2)).to(beta.dtype),
        None if scale is None else (df * gn).sum(dim=2).to(scale.dtype),
        None if shift is None else df.sum(dim=2).to(shift.dtype),
    )


# The cluster route (csrc/groupnorm.cu, gn_cluster): a cluster of 2, 4 or 8
# CTAs (8 is the portable limit) for each (batch, group) pair, each CTA holding
# its share of the pair's slab in shared memory
CLUSTER_SIZES = (2, 4, 8)
CLUSTER_THREADS = 512          # a CTA's threads; one takes each channel's affine
SMEM_PER_CTA = 232448 - 1024   # the H100's 227 KB a block, less the kernel's static arrays and a margin


class Route(NamedTuple):
    cluster: int   # CTAs a cluster; 0: the two-pass route
    smem: int      # bytes of dynamic shared memory a CTA


TWO_PASS = Route(0, 0)


def cluster_smem(c: int, hw: int, itemsize: int, cluster: int, groups: int = 8) -> int:
    """Bytes of dynamic shared memory a CTA of the cluster route takes: its
    share of the slab's 16-byte units, its partial sums (16 bytes) and the
    affine of each of the group's channels (8 bytes each); as
    ``cluster_smem`` in csrc/groupnorm.cu."""
    units = -(-(c // groups) * hw * itemsize // 16)
    return -(-units // cluster) * 16 + 16 + 8 * (c // groups)


def gn_route(b: int, c: int, hw: int, itemsize: int, active: Callable[[int, int], int], groups: int = 8) -> Route:
    """The kernel's route for x of (b, c, hw pixels) with ``itemsize``-byte
    elements, on a card that holds ``active(cluster, smem)`` clusters of a
    shape at once. Of the cluster sizes 2, 4 and 8 whose CTAs fit the card's
    shared memory, the one that runs the b * groups clusters in the fewest
    rounds, and of those the smallest. (On an H100 two CTAs a slab were as
    fast as one or faster at every call shape of the default UNet, and more
    paid off only where they cut the rounds: scripts/port/kernel_sweeps.py.) A slab that no
    cluster of 8 CTAs holds takes the two passes. Raises if the card can
    schedule none of the clusters that fit."""
    if c // groups > CLUSTER_THREADS:
        return TWO_PASS
    fits = [Route(s, cluster_smem(c, hw, itemsize, s, groups)) for s in CLUSTER_SIZES]
    fits = [r for r in fits if r.smem <= SMEM_PER_CTA]
    if not fits:
        return TWO_PASS
    held = {r: active(*r) for r in fits}
    if max(held.values()) < 1:
        raise RuntimeError(f"fused_group_norm_film_silu: the card can schedule none of the clusters {fits} "
                           f"(cudaOccupancyMaxActiveClusters: {list(held.values())})")
    return min((r for r in fits if held[r] >= 1), key=lambda r: (-(-b * groups // held[r]), r.cluster))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("groupnorm")
    lib.gn_workspace_floats.argtypes = [ctypes.c_int] * 3
    lib.gn_workspace_floats.restype = ctypes.c_longlong
    lib.gn_active_clusters.argtypes = [ctypes.c_int] * 5
    lib.gn_active_clusters.restype = ctypes.c_int
    lib.gn_forward.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
        + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 3
    )
    lib.gn_forward.restype = ctypes.c_int
    return lib


@functools.cache
def _active_clusters(device: int, x_bf16: int, film_bf16: int, vec: int, cluster: int, smem: int) -> int:
    """How many clusters of a route's shape the card holds at once
    (cudaOccupancyMaxActiveClusters), asked once a shape and device; raises
    if the query fails."""
    with torch.cuda.device(device):
        n = _library().gn_active_clusters(x_bf16, film_bf16, vec, cluster, smem)
    if n < 0:
        raise RuntimeError(f"fused_group_norm_film_silu: cudaOccupancyMaxActiveClusters failed with CUDA error {-n}")
    return n


@functools.lru_cache(maxsize=None)
def _device_route(device: int, x_bf16: int, film_bf16: int, vec: int, b: int, c: int, hw: int, groups: int) -> Route:
    return gn_route(b, c, hw, 2 if x_bf16 else 4, functools.partial(_active_clusters, device, x_bf16, film_bf16, vec),
                    groups)


def _vec(x: torch.Tensor, groups: int) -> int:
    """Whether every (batch, group) slab of x starts 16-byte aligned and is
    whole 16-byte units: the cluster route's bulk copies and 16-byte stores."""
    b, c, h, w = x.shape
    size = x.element_size()
    return int((c // groups) * h * w * size % 16 == 0 and x.stride(0) * size % 16 == 0 and x.data_ptr() % 16 == 0)


def device_route(x: torch.Tensor, film_bf16: bool = False, groups: int = 8) -> Route:
    """The route the kernel takes for x (a CUDA tensor) on its card:
    ``gn_route`` with the card's counts of active clusters, asked once a
    shape. ``film_bf16``: bf16 FiLM rows beside a bf16 x."""
    b, c, h, w = x.shape
    return _device_route(x.device.index, int(x.dtype == torch.bfloat16), int(film_bf16), _vec(x, groups), b, c,
                         h * w, groups)


def film_rows(scale: Optional[torch.Tensor], shift: Optional[torch.Tensor], x: torch.Tensor, c: int):
    """scale and shift as a kernel takes them: fp32, or bf16 beside a bf16
    x, each (B, c) with unit column stride and one row stride for both,
    which the halves of a (B, 2c) time-MLP output have without a copy.
    Returns (scale, shift, row stride, are they bf16)."""
    b = x.shape[0]
    rows = [t for t in (scale, shift) if t is not None]
    if not rows:
        return None, None, 0, False
    bf16 = x.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in rows)
    out = []
    for t in (scale, shift):
        if t is not None:
            if t.shape != (b, c) or t.device != x.device:
                raise ValueError(f"FiLM rows must be (B, C) = {(b, c)} on {x.device}, got {tuple(t.shape)} on {t.device}")
            if not bf16:
                t = t.float()
            if t.stride(1) != 1:
                t = t.contiguous()
        out.append(t)
    strides = {t.stride(0) for t in out if t is not None}
    if len(strides) > 1:
        out = [None if t is None else t.contiguous() for t in out]
        strides = {c}
    return out[0], out[1], strides.pop(), bf16


def check_activation(x: torch.Tensor, what: str) -> None:
    """The kernels take NCHW fp32 or bf16 activations with any batch stride,
    contiguous within each batch element."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{what} takes x of shape (B, C, H, W), got {tuple(x.shape)}")
    if x.shape[0] and not x[0].is_contiguous():
        raise ValueError(f"{what} takes x contiguous within each batch element, got strides {x.stride()}")


def _vector(t: torch.Tensor, c: int, x: torch.Tensor) -> torch.Tensor:
    if t.numel() != c or t.device != x.device:
        raise ValueError(f"a per-channel vector of shape {tuple(t.shape)} on {t.device} for C={c} on {x.device}")
    return t.detach().float().reshape(c).contiguous()


def _forward(x, gamma, beta, scale, shift, groups: int, eps: float, route: Optional[Route] = None) -> torch.Tensor:
    """Launch the kernel: out (B, C, H, W) in x's dtype, contiguous. The
    route is ``gn_route``'s for this card unless one is given, for
    measurements that compare routes."""
    check_activation(x, "fused_group_norm_film_silu")
    b, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"C={c} is not a multiple of groups={groups}")
    gamma, beta = _vector(gamma, c, x), _vector(beta, c, x)
    scale, shift, film_stride, film_bf16 = film_rows(scale, shift, x, c)
    lib = _library()
    if route is None:
        route = device_route(x, film_bf16, groups)
    with torch.cuda.device(x.device):
        out = torch.empty((b, c, h, w), device=x.device, dtype=x.dtype)
        ws = torch.empty(lib.gn_workspace_floats(b, c, h * w) if route.cluster == 0 else 0, device=x.device,
                         dtype=torch.float32)
        err = lib.gn_forward(
            int(x.dtype == torch.bfloat16), int(film_bf16), x.data_ptr(), x.stride(0),
            gamma.data_ptr(), beta.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), film_stride, b, c, groups, h * w,
            float(eps), route.cluster, _vec(x, groups), ws.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_group_norm_film_silu kernel launch failed with CUDA error {err}")
    fused_group_norm_film_silu.launches += 1
    return out


class _GroupNormFilmSiLUCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, groups, eps):
        ctx.save_for_backward(x, gamma, beta, scale, shift)
        ctx.groups, ctx.eps = groups, eps
        return _forward(x, gamma, beta, scale, shift, groups, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        x, gamma, beta, scale, shift = ctx.saved_tensors
        grads = group_norm_film_silu_backward_reference(x, gamma, beta, scale, shift, grad_out, ctx.groups, ctx.eps)
        return (*grads, None, None)


def fused_group_norm_film_silu(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """GroupNorm(groups) -> x*(scale+1)+shift -> SiLU over x (B, C, H, W);
    output in x's dtype.

    CUDA tensors (fp32 or bf16, contiguous within each batch element, C a
    multiple of ``groups``) go through the kernel on ``gn_route``'s route,
    counted in ``fused_group_norm_film_silu.launches``; its backward is the plain
    analytic VJP and launches nothing. CPU tensors go through
    ``group_norm_film_silu_reference``.
    """
    if x.device.type == "cpu":
        return group_norm_film_silu_reference(x, gamma, beta, scale, shift, groups, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_group_norm_film_silu runs on cuda or cpu tensors, got {x.device}")
    return _GroupNormFilmSiLUCUDA.apply(x, gamma, beta, scale, shift, groups, float(eps))


fused_group_norm_film_silu.launches = 0
