"""The port's linear attention against the JAX package's Pallas kernels.

On the CPU the port's wrapper runs its plain version, which is held here
against the Pallas forward in interpret mode and against the JAX reference,
on the same numpy inputs (atol 1e-5, fp32). The plain analytic backward is
held against ``jax.vjp`` through the Pallas kernel in interpret mode (which
runs ``_bwd_kernel``) and against torch autograd of the plain forward, at
2e-4 (the fp32 VJP tolerance of KERNELS.json) of each gradient's largest
entry. The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py``; what surrounds them (the layout and type checks) is
Python and is tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.ops.pallas.linear_attention import (
    linear_attention_interpret as jax_la_interpret,
    linear_attention_reference as jax_la_reference,
)
from tedm_tpu_torch.kernels import linear_attention as la

torch.set_num_threads(1)

SCALE = 32 ** -0.5


def _qkv(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(2, 4, 32, n) * 2).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", [256, 1024])
def test_plain_version_matches_pallas(n):
    q, k, v = _qkv(n)
    got = la.linear_attention_reference(*map(torch.from_numpy, (q, k, v)), SCALE).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(got, np.asarray(jax_la_interpret(jq, jk, jv, SCALE)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_la_reference(jq, jk, jv, SCALE)), atol=1e-5, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(256, seed=1))
    before = la.linear_attention.launches
    out = la.linear_attention(q, k, v, SCALE)
    assert la.linear_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, la.linear_attention_reference(q, k, v, SCALE), atol=0, rtol=0)
    assert out.dtype == torch.float32 and out.shape == q.shape


def test_kernel_checks_accept_qkv_conv_views():
    """The UNet hands the kernel chunks of its qkv conv output: views with
    the batch stride of the whole conv output, contiguous inside each batch
    element. The checks must take them without a copy."""
    qkv = torch.randn(2, 3 * 128, 16, 16)
    q, k, v = (t.reshape(2, 4, 32, 256) for t in qkv.chunk(3, dim=1))
    assert not q.is_contiguous() and q.stride(0) == 3 * 128 * 256
    la._check(q, k, v)


@pytest.mark.parametrize(
    "make,exc",
    [
        (lambda q: q.to(torch.bfloat16), TypeError),          # fp32 only until the bf16 slice
        (lambda q: q[:, :, :16].contiguous(), ValueError),    # d must be 32
        (lambda q: q.transpose(2, 3).contiguous().transpose(2, 3), ValueError),  # N not innermost
        (lambda q: q[..., :128], ValueError),                  # shapes differ
    ],
)
def test_kernel_checks_reject(make, exc):
    q, k, v = (torch.randn(2, 4, 32, 256) for _ in range(3))
    with pytest.raises(exc):
        la._check(make(q), k, v)


def _qkvg(n, seed=2):
    """v carries the factor N that the math divides out, so every gradient
    is far from zero."""
    rs = np.random.RandomState(seed)
    q, k, g = [(rs.randn(2, 4, 32, n) * 2).astype(np.float32) for _ in range(3)]
    return q, k, (rs.randn(2, 4, 32, n) * n).astype(np.float32), g


def _assert_grads_close(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and np.abs(b).max() > 0
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= 2e-4, (name, err)


@pytest.mark.parametrize("n", [256, 1024])
def test_plain_backward_matches_pallas_bwd_kernel(n):
    q, k, v, g = _qkvg(n)
    _, vjp = jax.vjp(lambda a, b, c: jax_la_interpret(a, b, c, SCALE), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    got = la.linear_attention_backward_reference(*map(torch.from_numpy, (q, k, v, g)), SCALE)
    _assert_grads_close([t.numpy() for t in got], want)


@pytest.mark.parametrize("n", [256, 1024])
def test_plain_backward_matches_autograd(n):
    q, k, v, g = _qkvg(n, seed=3)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    # the CPU wrapper is differentiable: autograd through the plain forward
    la.linear_attention(*leaves, SCALE).backward(torch.from_numpy(g))
    got = la.linear_attention_backward_reference(*map(torch.from_numpy, (q, k, v, g)), SCALE)
    _assert_grads_close([t.numpy() for t in got], [t.grad.numpy() for t in leaves])
    assert la.linear_attention.backward_launches == 0  # no kernel on the CPU


def test_backward_checks_take_a_strided_gradient():
    """The backward takes q, k, v as the forward took them and a gradient of
    any batch stride; a gradient that is not contiguous inside a batch
    element is refused by the checks (the wrapper copies it first)."""
    qkv = torch.randn(2, 3 * 128, 16, 16)
    q, k, v = (t.reshape(2, 4, 32, 256) for t in qkv.chunk(3, dim=1))
    g = torch.randn(2, 3 * 128, 256)[:, 128:256].reshape(2, 4, 32, 256)
    la._check(q, k, v, g)
    with pytest.raises(ValueError, match="g must be contiguous"):
        la._check(q, k, v, g.transpose(2, 3).contiguous().transpose(2, 3))


def test_kernel_bounds_read_the_default_unet():
    """The shapes behind PERF.md's bounds are the default UNet's: its 8
    linear attentions and 19 ResnetBlocks in call order, and row 1's bound
    is the bytes of q, k, v and out at 3.35 TB/s."""
    from tedm_tpu_torch.kernels import bounds
    from tedm_tpu_torch.models.unet import LinearAttention, ResnetBlock, Unet

    with torch.device("meta"):
        unet = Unet()
    attn, res = bounds.unet_stages()
    assert [c for c, _ in attn] == [m.to_qkv.in_channels for m in unet.modules() if isinstance(m, LinearAttention)]
    assert [s for _, s in attn] == [128, 64, 32, 16, 16, 32, 64, 128]
    blocks = [m for m in unet.modules() if isinstance(m, ResnetBlock)]
    order = [b for stage in unet.downs for b in stage[:2]] + [unet.mid_block1, unet.mid_block2] + [
        b for stage in unet.ups for b in stage[:2]] + [unet.final_res_block]
    assert len(blocks) == len(order) == len(res) == 19
    assert [(c_in, c_out) for c_in, c_out, _ in res] == [
        (b.block1.proj.in_channels, b.block1.proj.out_channels) for b in order]
    row = bounds.kernel_bounds(8)["linear_attention"]
    assert row["calls"] == 8 and row["bound_by"] == "bytes"
    assert abs(row["bound_ms"] - 1e3 * 2 * sum(4 * 4 * 8 * 128 * n for n in (256, 1024, 4096, 16384)) / 3.35e12) < 1e-9
