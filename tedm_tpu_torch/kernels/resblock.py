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
``autograd.Function``. When autograd needs the block, the forward keeps its
fp32 conv outputs h1 and h2 and the GroupNorms' statistics, and the
backward runs from them: the GroupNorm (+ FiLM) + SiLU gradients by the
kernels of ``csrc/resblock_backward.cu``, the convolutions' gradients by
one convolution backward each in the compute dtype, as XLA runs JAX's
transposes (``resnet_block_backward_reference`` is its plain version). On
a CPU tensor it runs ``resnet_block_reference``, differentiated by
autograd. The forward is the ``tedm_tpu_torch::resnet_block`` op
(``kernels/ops.py``), whose CPU implementation is
``resnet_block_forward_reference``.

Weights come in the port's layout: ``w1`` (Cout, Cin, 3, 3), ``w2`` (Cout,
Cout, 3, 3), ``wres`` (Cout, Cin, 1, 1) or None, biases and GroupNorm
gains and shifts (Cout,), FiLM ``scale``/``shift`` (B, Cout) or None. They
stay fp32; a convolution in the compute dtype rounds both operands to it
and sums in fp32, as ``preferred_element_type=jnp.float32`` does. The
kernel reads each conv weight in its tensor-core layout
(``tc_weight_layout``): bf16 values, or for fp32 the TF32 hi and lo parts
of the split-TF32 products. A layout is built once per weight, compute
dtype, version (``Tensor._version``, which an optimizer's in-place step
bumps) and storage of the weight, and kept while the weight lives, so a
served model builds each once and a trained one once per step
(``kernels/layouts.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from tedm_tpu_torch.kernels import _build, layouts, ops
from tedm_tpu_torch.kernels.tf32 import tf32_round, tf32_split  # noqa: F401 (tf32_round: the tests read it here)
from tedm_tpu_torch.kernels.groupnorm import (
    check_activation, film_rows, group_norm_film_silu_backward_reference, group_norm_film_silu_reference,
    group_stats,
)


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
    args = (x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres)
    h1, h2 = resnet_block_saved_reference(*args, groups=groups, eps=eps, pad_after_norm=pad_after_norm)
    return _block_output(x, h2, g2, be2, wres, bres, groups, eps)


def _block_output(x, h2, g2, be2, wres, bres, groups, eps) -> torch.Tensor:
    """GN2 + SiLU of the fp32 h2 plus the residual, summed in fp32 and cast once."""
    h = group_norm_film_silu_reference(h2, g2, be2, None, None, groups, eps)
    res = x.float() if wres is None else F.conv2d(_rounded(x, x.dtype), _rounded(wres, x.dtype)) + _col(bres)
    return (h + res).to(x.dtype)


def resnet_block_forward_reference(
    x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres=None, bres=None,
    groups: int = 8, eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of what the kernel's forward returns: the block's output
    (``resnet_block_reference``'s, contiguous) and the fp32 buffer it keeps
    for the backward, in the layout ``saved_views`` reads: GN1's and GN2's
    affines (a, b) with GN(h) * gamma, FiLM and shift folded into h * a + b
    (``gn::film_affine``), their group statistics (mean, rstd), then h1
    and h2."""
    args = (x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres)
    h1, h2 = resnet_block_saved_reference(*args, groups=groups, eps=eps)
    b, c = h1.shape[:2]
    coefs, stats = [], []
    for h, gamma, beta, sc, sh in ((h1, g1, be1, scale, shift), (h2, g2, be2, None, None)):
        mean, rstd = group_stats(h, groups, eps)  # (B, groups, 1) each
        m, r = (t.repeat_interleave(c // groups, dim=1) for t in (mean, rstd))
        gamma, beta = gamma.float().reshape(1, c, 1), beta.float().reshape(1, c, 1)
        film = 1.0 if sc is None else sc.float().reshape(b, c, 1) + 1.0
        a = r * gamma * film
        off = (beta - m * r * gamma) * film + (0.0 if sh is None else sh.float().reshape(b, c, 1))
        coefs.append(torch.cat([a, off], dim=2))
        stats.append(torch.cat([mean, rstd], dim=2))
    saved = torch.cat([t.reshape(-1) for t in (*coefs, *stats, h1, h2)])
    return _block_output(x, h2, g2, be2, wres, bres, groups, eps).contiguous(), saved


def _rounded(t: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """t as an operand of a product in cdt: rounded to cdt, held in fp32."""
    return t.to(cdt).float()


def _col(t: torch.Tensor) -> torch.Tensor:
    return t.float().reshape(1, -1, 1, 1)


def resnet_block_saved_reference(
    x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres=None, bres=None,
    groups: int = 8, eps: float = 1e-5, pad_after_norm: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 conv outputs (h1, h2) of ``resnet_block_reference``: what
    the kernel's forward keeps for the backward."""
    cdt = x.dtype
    h1 = F.conv2d(_rounded(x, cdt), _rounded(w1, cdt), padding=1) + _col(b1)
    if pad_after_norm:
        h = group_norm_film_silu_reference(F.pad(h1, (1, 1, 1, 1)), g1, be1, scale, shift, groups, eps,
                                           stats=group_stats(h1, groups, eps))
        h2 = F.conv2d(_rounded(h, cdt), _rounded(w2, cdt)) + _col(b2)
    else:
        h = group_norm_film_silu_reference(h1, g1, be1, scale, shift, groups, eps)
        h2 = F.conv2d(_rounded(h, cdt), _rounded(w2, cdt), padding=1) + _col(b2)
    return h1, h2


def conv_grads(dy: torch.Tensor, inp: torch.Tensor, w: torch.Tensor, padding: int, cdt: torch.dtype,
               mask: Tuple[bool, bool], plain: bool = True):
    """(d inp, d w) of conv2d(inp, w, padding) for the output gradient dy,
    with every operand in cdt and fp32 sums: the data gradient in cdt, the
    weight gradient rounded to cdt and held in fp32 (the cast of the fp32
    weight to cdt). ``plain``: fp32 convolutions of the rounded operands,
    rounded after; else one convolution backward in cdt (cuDNN on the card;
    fp32 with TF32 off). An entry of ``mask`` that is False gives None."""
    ops = [t.to(cdt) for t in (dy, inp, w)]
    if plain:
        ops = [t.float() for t in ops]
    with _no_tf32():
        gi, gw, _ = torch.ops.aten.convolution_backward(
            ops[0], ops[1], ops[2], None, [1, 1], [padding, padding], [1, 1], False, [0, 0], 1,
            [mask[0], mask[1], False])
    return (None if gi is None else gi.to(cdt)), (None if gw is None else gw.to(cdt).float())


@contextlib.contextmanager
def _no_tf32():
    """fp32 convolutions in full fp32, as the JAX block's Precision.HIGHEST."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


Grads = Tuple[Optional[torch.Tensor], ...]


def resnet_block_backward_reference(
    x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres,
    h1: torch.Tensor, h2: torch.Tensor, dout: torch.Tensor,
    groups: int = 8, eps: float = 1e-5, pad_after_norm: bool = False, film_dropped: bool = False,
) -> Grads:
    """Plain PyTorch version of the block's backward from what the forward
    keeps (x, the weights, the fp32 conv outputs h1 and h2; the GroupNorm
    statistics are taken again from them) and the output gradient dout:
    the gradients of the 13 inputs of ``resnet_block_reference``, None for
    an input that is None, by the formulas and rounding points of the
    kernel's backward (csrc/resblock_backward.cu):
    - the GroupNorms' gradients in fp32 (``group_norm_film_silu_backward_reference``);
      the conv biases' gradients fp32 sums of the fp32 dh;
    - each convolution's gradients with every operand in x's dtype (dh2,
      dh1 and dout rounded to it) and fp32 sums, the data gradient in x's
      dtype, the weight gradient rounded to it (``conv_grads``);
    - dx the sum, in x's dtype, of conv1's and the residual's data
      gradients, or of conv1's and dout on the identity.
    ``pad_after_norm`` and ``film_dropped`` are controls for checks: conv2's
    weight gradient taken over h1n padded after GN1+SiLU, or GN1's
    backward without FiLM (no dscale or dshift then)."""
    cdt = x.dtype
    d = dout.float()
    dh2, dg2, dbe2, _, _ = group_norm_film_silu_backward_reference(h2, g2, be2, None, None, d, groups, eps)
    fs, fh = (None, None) if film_dropped else (scale, shift)
    if pad_after_norm:
        h1n = group_norm_film_silu_reference(F.pad(h1, (1, 1, 1, 1)), g1, be1, fs, fh, groups, eps,
                                             stats=group_stats(h1, groups, eps))
        dh1n, dw2 = conv_grads(dh2, h1n, w2, 0, cdt, (True, True))
        dh1n = dh1n[:, :, 1:-1, 1:-1]
    else:
        h1n = group_norm_film_silu_reference(h1, g1, be1, fs, fh, groups, eps)
        dh1n, dw2 = conv_grads(dh2, h1n, w2, 1, cdt, (True, True))
    dh1, dg1, dbe1, dscale, dshift = group_norm_film_silu_backward_reference(
        h1, g1, be1, fs, fh, dh1n.float(), groups, eps)
    dx, dw1 = conv_grads(dh1, x, w1, 1, cdt, (True, True))
    dwres = dbres = None
    if wres is None:
        dx = dx + dout.to(cdt)
    else:
        dxr, dwres = conv_grads(d, x, wres, 0, cdt, (True, True))
        dx, dbres = dx + dxr, d.sum(dim=(0, 2, 3))
    return (dx, dw1, dh1.sum(dim=(0, 2, 3)), dg1, dbe1, dscale, dshift,
            dw2, dh2.sum(dim=(0, 2, 3)), dg2, dbe2, dwres, dbres)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("resblock")
    lib.rb_saved_floats.argtypes = [ctypes.c_int] * 5
    lib.rb_saved_floats.restype = ctypes.c_longlong
    lib.rb_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.rb_scratch_floats.restype = ctypes.c_longlong
    lib.rb_forward.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 5
        + [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6
        + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 4
    )
    lib.rb_forward.restype = ctypes.c_int
    return lib


@functools.cache
def _backward_library() -> ctypes.CDLL:
    lib = _build.load("resblock_backward")
    lib.rb_gn_backward_floats.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    lib.rb_gn_backward_floats.restype = ctypes.c_longlong
    lib.rb_gn_backward.argtypes = (
        [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_longlong] + [ctypes.c_void_p] * 12
    )
    lib.rb_gn_backward.restype = ctypes.c_int
    return lib


BN = 64  # output channels of a kernel block, the wgmma's N
# input channels of a chunk and values in 16 bytes, by compute dtype
_CHUNK = {torch.bfloat16: (32, 8), torch.float32: (8, 4)}
LAYOUT_RANGE = "fused_resnet_block weight layout"  # profiler range of a layout build


def tc_weight_layout(w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """A (Cout, Cin, k, k) conv weight as the kernel's bulk copies read it:
    for each block of 64 output channels and chunk of KC input channels
    (32 in bf16, 8 in fp32), one contiguous run that is the shared-memory B
    operand of all k*k taps, [plane][tap][k-step][n group of 8][k half][8
    rows][16 bytes]: the wgmma no-swizzle K-major layout (csrc/tensor_core.cuh).
    bf16: one plane of bf16 values; fp32: the TF32 hi and lo planes.
    Output channels pad to 64 and input channels to KC with zeros."""
    cout, cin, k, _ = w.shape
    taps = k * k
    kc, e = _CHUNK[cdt]
    nb, nc = -(-cout // BN), -(-cin // kc)
    wp = torch.zeros(nb * BN, nc * kc, taps, device=w.device, dtype=torch.float32)
    wp[:cout, :cin] = w.detach().float().reshape(cout, cin, taps)
    planes = [wp.to(cdt)] if cdt == torch.bfloat16 else list(tf32_split(wp))
    t = torch.stack(planes).reshape(len(planes), nb, BN // 8, 8, nc, kc // (2 * e), 2, e, taps)
    # (plane, nb, n group, row, chunk, k-step, k half, value, tap) -> the layout's order
    return t.permute(1, 4, 0, 8, 5, 2, 6, 3, 7).contiguous()


_layouts = layouts._cache  # shared with the other kernels' layouts, keyed (id(w), layout key)


def cached_weight_layout(w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``tc_weight_layout(w, cdt)``, rebuilt when w's version moves (an
    in-place update) or its storage does (``w.data = t``, ``Module.to``),
    and dropped when w is freed (``layouts.cached_layout``). An inference
    tensor has no version counter and is laid out on every call."""
    return layouts.cached_layout(w, cdt, lambda t: _build_layout(t, cdt))


def _build_layout(w: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    with torch.profiler.record_function(LAYOUT_RANGE), torch.no_grad():
        fused_resnet_block.layouts_built += 1
        return tc_weight_layout(w, cdt)


def _weight(w: torch.Tensor, cout: int, cin: int, k: int, x: torch.Tensor) -> torch.Tensor:
    if w.shape != (cout, cin, k, k) or w.device != x.device:
        raise ValueError(f"a conv weight of shape {tuple(w.shape)} on {w.device}, expected "
                         f"{(cout, cin, k, k)} on {x.device}")
    return cached_weight_layout(w, x.dtype)


def saved_views(saved: torch.Tensor, b: int, c: int, h: int, w: int, groups: int) -> Dict[str, torch.Tensor]:
    """What the kernel's forward keeps (csrc/resblock.cu, rb_saved_floats),
    as views: GN1's and GN2's affines ``coef1``, ``coef2`` (B, C, 2), group
    statistics ``stats1``, ``stats2`` (B, groups, 2) as (mean, rstd), and
    the fp32 conv outputs ``h1``, ``h2`` (B, C, H, W)."""
    bc, bg, act = b * c, b * groups, b * c * h * w
    at = [0, 2 * bc, 4 * bc, 4 * bc + 2 * bg, 4 * bc + 4 * bg, 4 * bc + 4 * bg + act]
    return {"coef1": saved[at[0]:at[1]].view(b, c, 2), "coef2": saved[at[1]:at[2]].view(b, c, 2),
            "stats1": saved[at[2]:at[3]].view(b, groups, 2), "stats2": saved[at[3]:at[4]].view(b, groups, 2),
            "h1": saved[at[4]:at[5]].view(b, c, h, w), "h2": saved[at[5]:at[5] + act].view(b, c, h, w)}


def _forward(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, groups, eps):
    """Launch the kernels: out (B, Cout, H, W) in x's dtype, contiguous, and
    what they keep for the backward (``saved_views``)."""
    check_activation(x, "fused_resnet_block")
    b, cin, h, w = x.shape
    cout = w1.shape[0]
    if cout % groups or cout % 4 or cout // groups > 1024:
        raise ValueError(f"Cout={cout} must be a multiple of groups={groups} (at most 1024 channels a group) and of 4")
    if wres is None and cin != cout:
        raise ValueError(f"the identity residual needs Cin == Cout, got {cin} and {cout}")
    cdt = x.dtype
    vec = [t.detach().float().reshape(cout).contiguous() for t in (b1, g1, be1, b2, g2, be2)]
    if any(t.device != x.device for t in vec):
        raise ValueError(f"biases and gains must be on {x.device}")
    w1t = _weight(w1, cout, cin, 3, x)
    w2t = _weight(w2, cout, cout, 3, x)
    wrest = None if wres is None else _weight(wres, cout, cin, 1, x)
    brest = None if wres is None else bres.detach().float().reshape(cout).contiguous()
    scale, shift, film_stride, film_bf16 = film_rows(scale, shift, x, cout)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty((b, cout, h, w), device=x.device, dtype=cdt)
        saved = torch.empty(lib.rb_saved_floats(b, cout, h, w, groups), device=x.device, dtype=torch.float32)
        scratch = torch.empty(lib.rb_scratch_floats(b, cout, h, w), device=x.device, dtype=torch.float32)
        err = lib.rb_forward(
            int(cdt == torch.bfloat16), int(film_bf16), x.data_ptr(), x.stride(0), b, cin, cout, h, w,
            w1t.data_ptr(), vec[0].data_ptr(), vec[1].data_ptr(), vec[2].data_ptr(), ptr(scale), ptr(shift),
            film_stride, w2t.data_ptr(), vec[3].data_ptr(), vec[4].data_ptr(), vec[5].data_ptr(),
            ptr(wrest), ptr(brest), groups, float(eps), saved.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_resnet_block kernel launch failed with CUDA error {err}")
    fused_resnet_block.launches += 1
    return out, saved


def _gn_backward(h, da, coef, stats, gamma, beta, scale, shift, x, groups, h1n_from=None):
    """One GroupNorm's backward kernels (csrc/resblock_backward.cu) over the
    fp32 h with the forward's affine and statistics, for da, the gradient of
    its output in x's dtype: dh in x's dtype and the fp32 sums (dgamma,
    dbeta, dbias, dscale, dshift, dsum of da); with ``h1n_from`` = (h1,
    coef1) also conv2's input h1n rebuilt. dscale and dshift None where
    scale and shift are, dsum only with ``h1n_from``."""
    b, c, hh, ww = h.shape
    cdt, dev = x.dtype, x.device
    gamma, beta = (t.detach().float().reshape(c).contiguous() for t in (gamma, beta))
    scale_rows, shift_rows, film_stride, film_bf16 = film_rows(scale, shift, x, c)
    da = da.to(cdt).contiguous()
    lib = _backward_library()
    f32 = dict(device=dev, dtype=torch.float32)
    dh = torch.empty_like(da)
    dgamma, dbeta, dbias = (torch.empty(c, **f32) for _ in range(3))
    dscale = None if scale is None else torch.empty(b, c, **f32)
    dshift = None if shift is None else torch.empty(b, c, **f32)
    dsum = h1n = None
    if h1n_from is not None:
        dsum, h1n = torch.empty(c, **f32), torch.empty_like(da)
    ws = torch.empty(lib.rb_gn_backward_floats(b, c, hh * ww), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.rb_gn_backward(
        int(cdt == torch.bfloat16), int(film_bf16), h.data_ptr(), da.data_ptr(), coef.data_ptr(), stats.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), ptr(scale_rows), ptr(shift_rows), film_stride, b, c, groups, hh * ww,
        ws.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(), dbias.data_ptr(), ptr(dscale), ptr(dshift), ptr(dsum),
        dh.data_ptr(), None if h1n_from is None else h1n_from[0].data_ptr(),
        None if h1n_from is None else h1n_from[1].data_ptr(), ptr(h1n), torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_resnet_block backward kernel launch failed with CUDA error {err}")
    as_film = lambda g, t: None if g is None else g.to(t.dtype)
    return dh, dgamma, dbeta, dbias, as_film(dscale, scale), as_film(dshift, shift), dsum, h1n


def _backward(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, saved, dout, groups,
              needs: Tuple[bool, ...]) -> Grads:
    """The block's backward on the card from what ``_forward`` kept: the
    GroupNorm passes by the kernels, the convolutions' gradients by
    ``conv_grads`` in x's dtype; the function of
    ``resnet_block_backward_reference``. Gradients that ``needs`` does not
    ask for come back None, or are not computed where that saves a
    convolution."""
    b, cin, hh, ww = x.shape
    cout, cdt = w1.shape[0], x.dtype
    v = saved_views(saved, b, cout, hh, ww, groups)
    with torch.cuda.device(x.device):
        dh2, dg2, dbe2, db2, _, _, dbres, h1n = _gn_backward(
            v["h2"], dout, v["coef2"], v["stats2"], g2, be2, None, None, x, groups, h1n_from=(v["h1"], v["coef1"]))
        dh1n, dw2 = conv_grads(dh2, h1n, w2, 1, cdt, (True, needs[7]), plain=False)
        del dh2, h1n
        dh1, dg1, dbe1, db1, dscale, dshift, _, _ = _gn_backward(
            v["h1"], dh1n, v["coef1"], v["stats1"], g1, be1, scale, shift, x, groups)
        del dh1n
        dx, dw1 = conv_grads(dh1, x, w1, 1, cdt, (needs[0], needs[1]), plain=False)
        dwres = None
        if wres is None:
            dx, dbres = None if dx is None else dx + dout.to(cdt), None
        else:
            dxr, dwres = conv_grads(dout, x, wres, 0, cdt, (needs[0], needs[11]), plain=False)
            dx = None if dx is None else dx + dxr
    fused_resnet_block.backward_launches += 1
    grads = (dx, dw1, db1, dg1, dbe1, dscale, dshift, dw2, db2, dg2, dbe2, dwres, dbres)
    return tuple(g if need else None for g, need in zip(grads, needs))


class _ResnetBlockCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, groups, eps):
        out, saved = ops.resnet_block(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, groups, eps)
        if any(ctx.needs_input_grad):  # training: keep h1, h2 and the GroupNorms' statistics
            ctx.save_for_backward(x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres, saved)
            ctx.groups = groups
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        *args, saved = ctx.saved_tensors
        return (*_backward(*args, saved, grad_out, ctx.groups, ctx.needs_input_grad[:13]), None, None)


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
    ``fused_resnet_block.launches``; their backward, from the fp32 h1 and
    h2 the forward keeps, through the backward kernels, counted in
    ``fused_resnet_block.backward_launches``. CPU tensors go through
    ``resnet_block_reference``, differentiated by autograd. A call that
    autograd does not record is one call of the ``ops.resnet_block`` op.
    """
    args = (x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_resnet_block runs on cuda or cpu tensors, got {x.device}")
    if not ops.needs_grad(*args):
        return ops.resnet_block(*args, groups, float(eps))[0]
    if x.device.type == "cpu":
        return resnet_block_reference(*args, groups=groups, eps=eps)
    return _ResnetBlockCUDA.apply(*args, groups, float(eps))


fused_resnet_block.launches = 0
fused_resnet_block.backward_launches = 0
fused_resnet_block.layouts_built = 0  # tensor-core weight layouts built (cached_weight_layout)
