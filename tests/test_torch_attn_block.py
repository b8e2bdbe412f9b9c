"""The port's fused PreNorm linear-attention block against the JAX package's.

On the CPU the port's wrapper runs its plain version,
``prenorm_linear_attention_reference``, which is held here against JAX's
``prenorm_linear_attention_reference`` and, in fp32, against the Pallas
kernel in interpret mode, on the same numpy inputs: fp32 at 2e-5 (the fp32
forward tolerance of KERNELS.json), bf16 at 5e-2 (its bf16 tolerance; the
two agree to one bf16 ulp of the output, 1.56e-2 at |out| < 4), and the fp32 VJP in x
and all five weights at 2e-4 of each gradient's largest entry. JAX's layout
is (B, N, C) with matmul-layout weights; the port's is (B, C, N) with conv
weights, so the tests permute at the boundary. The CUDA kernel is held
against the plain version on the card by ``chip_smoke.py``; the checks
around it are Python and are tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.ops.pallas.attn_block import (
    prenorm_linear_attention_interpret as jax_interpret,
    prenorm_linear_attention_reference as jax_reference,
)
from tedm_tpu_torch.kernels import attn_block as ab
from tedm_tpu_torch.models import unet as U

torch.set_num_threads(1)

HIDDEN = 128


def _inputs(b, n, c, seed=0):
    """JAX-layout inputs: x (B, N, C), w_qkv (C, 3*128), w_out (128, C).

    Scaled so that the attention moves the output: at a conv's default init
    the context is about N**-1.5 and its share of the output falls below
    one bf16 ulp. The v columns of w_qkv carry the factor N that the context
    divides out, the k columns are doubled (k's softmax over N is then far
    from uniform), w_out is 4x; x and g_out at 0.5 keep |out| below 4."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    w_qkv = f(c, 3 * HIDDEN) * c ** -0.5
    w_qkv[:, HIDDEN:2 * HIDDEN] *= 2
    w_qkv[:, 2 * HIDDEN:] *= n
    return dict(
        x=0.5 * f(b, n, c), g_in=1 + 0.1 * f(c), w_qkv=w_qkv,
        w_out=4 * f(HIDDEN, c) * HIDDEN ** -0.5, b_out=0.1 * f(c), g_out=0.5 * (1 + 0.1 * f(c)),
    )


def _port_args(inp, dtype=torch.float32):
    """The same inputs in the port's layout: x (B, C, N), conv-layout weights."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return (t(inp["x"].transpose(0, 2, 1)).to(dtype), t(inp["g_in"]).reshape(1, -1, 1, 1),
            t(inp["w_qkv"].T).reshape(3 * HIDDEN, -1, 1, 1), t(inp["w_out"].T).reshape(-1, HIDDEN, 1, 1),
            t(inp["b_out"]), t(inp["g_out"]).reshape(1, -1, 1, 1))


def _nnc(t):
    return t.detach().float().numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("n,c", [(256, 64), (64, 128), (100, 256)])
def test_plain_version_matches_jax_in_fp32(n, c):
    inp = _inputs(2, n, c)
    got = _nnc(ab.prenorm_linear_attention_reference(*_port_args(inp)))
    jinp = {k: jnp.asarray(v) for k, v in inp.items()}
    np.testing.assert_allclose(got, np.asarray(jax_reference(**jinp)), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_interpret(**jinp)), atol=2e-5, rtol=0)


@pytest.mark.parametrize("n,c", [(256, 64), (64, 128), (16, 512)])
def test_plain_version_matches_jax_in_bf16(n, c):
    inp = _inputs(2, n, c, seed=1)
    got = ab.prenorm_linear_attention_reference(*_port_args(inp, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    jinp = {k: jnp.asarray(v) for k, v in inp.items()}
    jinp["x"] = jinp["x"].astype(jnp.bfloat16)
    want = np.asarray(jax_reference(**jinp).astype(jnp.float32))
    err = np.abs(_nnc(got) - want).max()
    assert err <= 5e-2, err


@pytest.mark.parametrize("cols", ["v", "k", "q"])
def test_inputs_make_every_stage_visible(cols):
    """On the inputs above, zeroing the v, k or q columns of w_qkv (the
    context, k's weighting over N, q's weighting over d) moves the bf16
    output by far more than the 5e-2 tolerance, so a comparison at that
    tolerance sees each stage."""
    inp = _inputs(2, 256, 64, seed=1)
    base = ab.prenorm_linear_attention_reference(*_port_args(inp, torch.bfloat16)).float()
    part = {"q": slice(0, HIDDEN), "k": slice(HIDDEN, 2 * HIDDEN), "v": slice(2 * HIDDEN, None)}[cols]
    inp["w_qkv"][:, part] = 0
    moved = (ab.prenorm_linear_attention_reference(*_port_args(inp, torch.bfloat16)).float() - base).abs().max()
    assert moved > 0.5, moved


def test_plain_vjp_matches_jax_in_fp32():
    inp = _inputs(2, 128, 64, seed=2)
    g = np.random.RandomState(3).randn(2, 128, 64).astype(np.float32)
    names = ("x", "g_in", "w_qkv", "w_out", "b_out", "g_out")
    _, vjp = jax.vjp(lambda *a: jax_reference(*a), *(jnp.asarray(inp[k]) for k in names))
    want = vjp(jnp.asarray(g))
    leaves = [t.requires_grad_() for t in _port_args(inp)]
    # the CPU wrapper is differentiable: autograd through the plain version
    ab.prenorm_linear_attention(*leaves).backward(torch.from_numpy(g.transpose(0, 2, 1).copy()))
    got = [_nnc(leaves[0].grad), leaves[1].grad.reshape(-1).numpy(),
           leaves[2].grad.reshape(3 * HIDDEN, -1).numpy().T, leaves[3].grad.reshape(-1, HIDDEN).numpy().T,
           leaves[4].grad.numpy(), leaves[5].grad.reshape(-1).numpy()]
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and np.abs(b).max() > 0
        assert np.abs(a - b).max() <= 2e-4 * np.abs(b).max(), name


def test_cpu_tensors_take_the_plain_version():
    args = _port_args(_inputs(1, 64, 64, seed=4), torch.bfloat16)
    before = ab.prenorm_linear_attention.launches
    out = ab.prenorm_linear_attention(*args)
    assert ab.prenorm_linear_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, ab.prenorm_linear_attention_reference(*args), atol=0, rtol=0)


def test_kernel_checks():
    """The kernel takes bf16, C a multiple of 16 up to 512, and x with any
    batch stride but contiguous inside each image (a view of a wider
    activation goes in without a copy)."""
    wide = torch.zeros(2, 3 * 64, 100, dtype=torch.bfloat16)
    ab._check(wide[:, 64:128])
    for x, exc in [
        (torch.zeros(2, 64, 100), TypeError),                                # fp32 takes B.1
        (torch.zeros(2, 40, 100, dtype=torch.bfloat16), ValueError),          # C % 16
        (torch.zeros(2, 1024, 100, dtype=torch.bfloat16), ValueError),        # C > 512
        (torch.zeros(2, 100, 64, dtype=torch.bfloat16).transpose(1, 2), ValueError),  # N strided
    ]:
        with pytest.raises(exc):
            ab._check(x)


@pytest.mark.parametrize("dtype,fused", [(torch.bfloat16, 8), (torch.float32, 0)])
def test_unet_routes_bf16_blocks_through_the_fused_block(dtype, fused, monkeypatch):
    """A bf16 UNet sends all 8 Residual(PreNorm(LinearAttention)) blocks of
    the default depth through the fused block, and an fp32 UNet none; the
    linear-attention kernel's wrapper then runs only in fp32."""
    calls = {"fused": 0, "la": 0}
    fused_fn, la_fn = U.prenorm_linear_attention, U.linear_attention

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(U, "prenorm_linear_attention", count("fused", fused_fn))
    monkeypatch.setattr(U, "linear_attention", count("la", la_fn))
    unet = U.Unet(dim=16, dim_mults=(1, 2, 4, 8), dtype=dtype).eval()
    with torch.no_grad():
        out, feats = unet(torch.randn(1, 1, 32, 32), torch.tensor([5]), extract_features=True)
    assert calls == {"fused": fused, "la": 8 - fused}
    assert out.dtype == dtype and all(f.dtype == dtype for f in feats)
    assert all(p.dtype == torch.float32 for p in unet.parameters())


def test_kernel_bound_reads_the_default_unet():
    """Row 2 of PERF.md's table: the bf16 block's bytes (x read, out written,
    the two 1x1 convs' weights) and tensor-core operations at the default
    UNet's 8 shapes."""
    from tedm_tpu_torch.kernels import bounds

    row = bounds.kernel_bounds(8)["prenorm_linear_attention (bf16)"]
    assert row["calls"] == 8
    attn, _ = bounds.unet_stages()
    by_bytes = sum(2 * (2 * 8 * c * s * s + 4 * HIDDEN * c) for c, s in attn) / 3.35e12
    assert row["bound_ms"] >= 1e3 * by_bytes > 0.03
