"""The backward of the port's whole-ResnetBlock kernel (B.4) against autograd and the JAX package.

On the card ``fused_resnet_block``'s backward runs from what its forward
keeps (the fp32 conv outputs h1 and h2 and the GroupNorms' statistics):
the GroupNorm (+ FiLM) + SiLU gradients by the kernels of
``csrc/resblock_backward.cu``, the convolutions' gradients by one
convolution backward each in the compute dtype. Its plain version,
``resnet_block_backward_reference``, is held here on the CPU, from the
tensors the plain forward keeps (``resnet_block_saved_reference``):
- against autograd of ``resnet_block_reference`` and against ``jax.vjp`` of
  the JAX ``fused_resnet_block_interpret`` (JAX's ``_block_bwd``) on the
  same numpy inputs, fp32 at 2e-4 of each gradient's largest entry
  (KERNELS.json's VJP tolerance);
- in bf16 at 3e-2 of each gradient's largest entry, against autograd of
  the bf16 plain block and against JAX's fp32 VJP on the same bf16 values
  (JAX's own bf16 VJP of the block stops in this JAX version: the
  transpose of a bf16 convolution with an fp32 ``preferred_element_type``
  is a convolution of an fp32 cotangent with bf16 weights, which
  ``lax.conv_general_dilated`` refuses); both differ from it by about 5e-3
  (bf16 rounding of dh2, dh1 and dh1n);
- with a control that must move it above the gate: conv2's weight
  gradient taken over h1n padded after GN1+SiLU, the bug the forward's
  check is built to see.

The CUDA kernels run only on the card (``chip_smoke.py`` phase 3 holds
them against this plain version); their arithmetic, per-plane sums
(S1 = sum df, S2 = sum df xhat, S3 = sum xhat, S0 = sum dout), group means
and the closed form of the conv bias's gradient, is emulated here in plain
PyTorch and held against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tedm_tpu.ops.pallas.resblock import fused_resnet_block_interpret as jax_interpret
from tedm_tpu_torch.kernels import resblock as RB
from tedm_tpu_torch.kernels.groupnorm import group_stats

torch.set_num_threads(1)

NAMES = ("x", "w1", "b1", "g1", "be1", "scale", "shift", "w2", "b2", "g2", "be2", "wres", "bres")
CASES = [  # (Cin, Cout, H, W, FiLM): identity and 1x1 residual, with and without FiLM, odd H != W
    (16, 16, 5, 7, True), (16, 16, 5, 7, False), (16, 32, 5, 7, True), (16, 32, 6, 9, False), (16, 32, 1, 3, True),
]
GATE = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def _inputs(b, cin, cout, h, w, film, seed):
    """JAX-layout inputs (x NHWC, w1 and w2 HWIO, wres (Cin, Cout)), x and
    the FiLM rows bf16-exact so that both dtypes see the same values, and
    the output gradient g (NHWC)."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    exact = lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
    res = cin != cout
    inp = dict(
        x=exact(f(b, h, w, cin)), w1=f(3, 3, cin, cout) * (9 * cin) ** -0.5, b1=0.1 * f(cout), g1=1 + 0.1 * f(cout),
        be1=0.5 * f(cout), scale=exact(0.5 * f(b, cout)) if film else None, shift=exact(0.5 * f(b, cout)) if film else None,
        w2=f(3, 3, cout, cout) * (9 * cout) ** -0.5, b2=0.1 * f(cout), g2=1 + 0.1 * f(cout), be2=0.1 * f(cout),
        wres=f(cin, cout) * cin ** -0.5 if res else None, bres=0.1 * f(cout) if res else None,
    )
    return inp, f(b, h, w, cout)


def _port(inp, dtype):
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))
    out = {k: t(v) for k, v in inp.items()}
    out["x"] = t(inp["x"].transpose(0, 3, 1, 2)).to(dtype)
    for k in ("scale", "shift"):
        if out[k] is not None:
            out[k] = out[k].to(dtype)
    out["w1"], out["w2"] = (t(inp[k].transpose(3, 2, 0, 1)) for k in ("w1", "w2"))
    if inp["wres"] is not None:
        out["wres"] = t(inp["wres"].T[:, :, None, None])
    return [out[k] for k in NAMES]


def _to_jax_layout(name, t):
    t = t.detach().float()
    if name == "x":
        return t.numpy().transpose(0, 2, 3, 1)
    if name in ("w1", "w2"):
        return t.numpy().transpose(2, 3, 1, 0)
    if name == "wres":
        return t.numpy()[:, :, 0, 0].T
    return t.numpy()


def _plain_backward(args, dout, **kw):
    h1, h2 = RB.resnet_block_saved_reference(*args)
    return RB.resnet_block_backward_reference(*args, h1, h2, dout, **kw)


def _autograd(args, dout):
    leaves = [None if t is None else t.clone().requires_grad_() for t in args]
    RB.resnet_block_reference(*leaves).backward(dout)
    return [None if t is None else t.grad for t in leaves]


def _worst(got, want):
    """The largest error of any gradient relative to its largest entry;
    each pair must be both present or both None."""
    worst = 0.0
    for name, a, b in zip(NAMES, got, want):
        assert (a is None) == (b is None), name
        if b is not None:
            assert a.shape == b.shape, name
            worst = max(worst, ((a.float() - b.float()).abs().max() / b.float().abs().max()).item())
    return worst


def _nchw_grad(g, dtype):
    return torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 1, 2))).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout,h,w,film", CASES)
def test_plain_backward_matches_autograd(cin, cout, h, w, film, dtype):
    inp, g = _inputs(2, cin, cout, h, w, film, seed=cin + cout + h)
    args = _port(inp, dtype)
    dout = _nchw_grad(g, dtype)
    got = _plain_backward(args, dout)
    assert got[0].dtype == dtype and all(t.dtype == torch.float32 for t in got[1:5] + got[7:] if t is not None)
    assert _worst(got, _autograd(args, dout)) <= GATE[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout,h,w,film", CASES[:4])
def test_plain_backward_matches_jax_vjp(cin, cout, h, w, film, dtype):
    """Against jax.vjp of the Pallas block in interpret mode, in fp32 (see
    the module's docstring for bf16)."""
    inp, g = _inputs(2, cin, cout, h, w, film, seed=cin + cout + w)
    jargs = [None if inp[k] is None else jnp.asarray(inp[k]) for k in NAMES]
    live = [i for i, a in enumerate(jargs) if a is not None]

    def fn(*a):
        full = list(jargs)
        for i, v in zip(live, a):
            full[i] = v
        return jax_interpret(*full)

    _, vjp = jax.vjp(fn, *(jargs[i] for i in live))
    want = dict(zip(live, vjp(jnp.asarray(g))))
    got = _plain_backward(_port(inp, dtype), _nchw_grad(g, dtype))
    for i, name in enumerate(NAMES):
        if i not in want:
            assert got[i] is None, name
            continue
        w_ = np.asarray(want[i], np.float32)
        a = _to_jax_layout(name, got[i])
        assert a.shape == w_.shape and np.abs(w_).max() > 0, name
        assert np.abs(a - w_).max() <= GATE[dtype] * np.abs(w_).max(), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_conv2_padding_control_is_visible(dtype):
    """conv2's weight gradient over h1n padded after GN1+SiLU (SiLU(GN1(0))
    at the border instead of 0) moves dw2 five times the gate or more; so
    does GN1's backward without FiLM to dw1."""
    inp, g = _inputs(2, 16, 16, 6, 9, True, seed=7)
    args, dout = _port(inp, dtype), _nchw_grad(g, dtype)
    want = _plain_backward(args, dout)
    rel = lambda a, b: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
    padded = _plain_backward(args, dout, pad_after_norm=True)
    assert rel(padded[7], want[7]) > 5 * GATE[dtype]
    no_film = _plain_backward(args, dout, film_dropped=True)
    assert no_film[5] is None and rel(no_film[1], want[1]) > 5 * GATE[dtype]


def _film_affine(stats, gamma, beta, scale, shift):
    """(a, b') per (batch, channel) of f = a h + b', group_norm.cuh's film_affine."""
    mean, rstd = stats
    b = mean.shape[0]
    c = gamma.numel()
    mean, rstd = (t.reshape(b, -1, 1).expand(b, -1, c // t.reshape(b, -1).shape[1]).reshape(b, c) for t in stats)
    film = 1.0 if scale is None else scale.float() + 1.0
    a = rstd * gamma * film
    return a, (beta - mean * rstd * gamma) * film + (0.0 if shift is None else shift.float())


def _kernel_gn_backward(h, da, stats, gamma, beta, scale, shift, cdt, groups=8, span=2048):
    """gn_bwd_reduce -> gn_bwd_coefs -> gn_bwd_apply as the kernels compute
    them: per (b, c) span sums, group means of k S1 and k S2, (P, Q, R), the
    closed-form bias gradient and dh = P df + Q xhat + R in cdt."""
    b, c, hh, ww = h.shape
    n = hh * ww
    a, bb = _film_affine(stats, gamma, beta, scale, shift)
    hf = h.reshape(b, c, n)
    mean, rstd = (t.reshape(b, groups, 1).repeat_interleave(c // groups, 1) for t in stats)
    y = hf * a[..., None] + bb[..., None]
    s = torch.sigmoid(y)
    df = da.float().reshape(b, c, n) * s * (1 + y * (1 - s))
    xhat = (hf - mean) * rstd
    pad = (-n) % span
    spans = lambda t: F.pad(t, (0, pad)).reshape(b, c, -1, span).sum(-1).sum(-1)  # span partials, then spans
    s1, s2, s3, s0 = spans(df), spans(df * xhat), spans(xhat), spans(da.float().reshape(b, c, n))
    film = torch.ones(b, c) if scale is None else scale.float() + 1
    k = film * gamma
    group = lambda t: t.reshape(b, groups, -1).sum(-1).repeat_interleave(c // groups, 1) / (n * c // groups)
    m1, m2 = group(k * s1), group(k * s2)
    p, q, r = rstd[..., 0] * k, -rstd[..., 0] * m2, -rstd[..., 0] * m1
    dh = (p[..., None] * df + q[..., None] * xhat + r[..., None]).reshape(b, c, hh, ww)
    sums = dict(dgamma=(film * s2).sum(0), dbeta=(film * s1).sum(0), dbias=(p * s1 + q * s3 + r * n).sum(0),
                dscale=None if scale is None else (gamma * s2 + beta * s1).to(scale.dtype),
                dshift=None if shift is None else s1.to(shift.dtype), dsum=s0.sum(0))
    return dh.to(cdt), sums


def _kernel_route(args, h1, h2, dout, groups=8):
    """The CUDA backward's arithmetic in plain PyTorch (fp32 convolutions of
    rounded operands for the convolution backward)."""
    x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres = args
    cdt = x.dtype
    st1, st2 = group_stats(h1, groups), group_stats(h2, groups)
    dh2, s2 = _kernel_gn_backward(h2, dout, st2, g2, be2, None, None, cdt, groups)
    a1, bb1 = _film_affine(st1, g1, be1, scale, shift)
    y1 = h1 * a1[..., None, None] + bb1[..., None, None]
    h1n = (y1 / (1 + torch.exp(-y1))).to(cdt)
    dh1n, dw2 = RB.conv_grads(dh2, h1n, w2, 1, cdt, (True, True))
    dh1, s1 = _kernel_gn_backward(h1, dh1n, st1, g1, be1, scale, shift, cdt, groups)
    dx, dw1 = RB.conv_grads(dh1, x, w1, 1, cdt, (True, True))
    dwres = dbres = None
    if wres is None:
        dx = dx + dout
    else:
        dxr, dwres = RB.conv_grads(dout, x, wres, 0, cdt, (True, True))
        dx, dbres = dx + dxr, s2["dsum"]
    return (dx, dw1, s1["dbias"], s1["dgamma"], s1["dbeta"], s1["dscale"], s1["dshift"],
            dw2, s2["dbias"], s2["dgamma"], s2["dbeta"], dwres, dbres)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cin,cout,h,w,film", [CASES[0], CASES[3], (16, 32, 48, 50, True)])
def test_kernel_arithmetic_matches_the_plain_backward(cin, cout, h, w, film, dtype):
    """The kernels' per-plane sums (with planes of more than one span of
    2048 pixels at 48x50), group means and closed-form bias gradient give
    the plain version's gradients: fp32 to 2e-5 of each gradient's largest
    entry (the same function summed in another order), bf16 within the
    gate (dh rounded to bf16 from values that differ in the last fp32 bits)."""
    inp, g = _inputs(2, cin, cout, h, w, film, seed=11)
    args, dout = _port(inp, dtype), _nchw_grad(g, dtype)
    h1, h2 = RB.resnet_block_saved_reference(*args)
    want = RB.resnet_block_backward_reference(*args, h1, h2, dout)
    got = _kernel_route(args, h1, h2, dout)
    assert _worst(got, want) <= (2e-5 if dtype == torch.float32 else GATE[dtype])


def test_saved_layout():
    """saved_views cuts rb_saved_floats' buffer (4 B C + 4 B groups + 2 B C
    H W floats) into disjoint views that cover it, h1 and h2 16-byte aligned
    (their vector loads)."""
    b, c, h, w, groups = 3, 24, 5, 7, 8
    total = 4 * b * c + 4 * b * groups + 2 * b * c * h * w
    saved = torch.arange(total, dtype=torch.float32)
    v = RB.saved_views(saved, b, c, h, w, groups)
    seen = torch.cat([t.reshape(-1) for t in v.values()])
    assert torch.equal(seen.sort().values, saved)
    assert v["h1"].storage_offset() % 4 == 0 and v["h2"].storage_offset() % 4 == 0
    assert v["coef1"].shape == (b, c, 2) and v["stats2"].shape == (b, groups, 2) and v["h2"].shape == (b, c, h, w)


def test_cpu_backward_is_autograd_of_the_plain_version():
    """On the CPU the wrapper is the plain forward under autograd: no
    kernel launch, no backward launch."""
    inp, g = _inputs(1, 16, 32, 4, 4, True, seed=5)
    args = [None if t is None else t.requires_grad_() for t in _port(inp, torch.float32)]
    before = (RB.fused_resnet_block.launches, RB.fused_resnet_block.backward_launches)
    RB.fused_resnet_block(*args).backward(_nchw_grad(g, torch.float32))
    assert (RB.fused_resnet_block.launches, RB.fused_resnet_block.backward_launches) == before
    assert all(t.grad is not None for t in args if t is not None)
