"""The port's linear attention against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs its plain version, which is held here
against the Pallas kernel in interpret mode and against the JAX reference,
on the same numpy inputs (atol 1e-5, fp32). The CUDA kernel is held against
the plain version on the card by ``chip_smoke.py``; what surrounds it (the
layout and type checks) is Python and is tested here.
"""

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


def test_backward_raises_until_ported():
    with pytest.raises(NotImplementedError, match="_bwd_kernel"):
        la._LinearAttentionCUDA.backward(None, torch.zeros(1))
