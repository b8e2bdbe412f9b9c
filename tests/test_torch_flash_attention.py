"""The port's flash cosine attention (kernel B.5) against the JAX package's.

On the CPU the port's wrapper runs its plain version,
``cosine_attention_reference``, which is held here against the Pallas
kernel in interpret mode (``flash_cosine_attention_interpret``) on the same
numpy inputs: fp32 at 2e-5 (KERNELS.json's fp32 forward tolerance), bf16 at
3e-2 (the two round once, at the output), and the VJP in q, k and v
against ``jax.vjp`` of the interpret path (JAX's ``_flash_bwd``) at 2e-4 of
each gradient's largest entry. JAX's layout is (B, h, N, d), the port's
(B, h, d, N). The CUDA kernel is held against the plain version on the
card by ``chip_smoke.py``; the checks around it are Python and are tested
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.ops.pallas.flash_attention import flash_cosine_attention_interpret as jax_interpret
from tedm_tpu_torch.kernels import flash_attention as FA

torch.set_num_threads(1)

SCALE = 16.0


def _inputs(b, n, seed=0):
    """q, k, v in JAX's (B, 4, N, 32) layout."""
    rs = np.random.RandomState(seed)
    return [rs.randn(b, 4, n, 32).astype(np.float32) for _ in range(3)]


def _port(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 1, 3, 2))).to(dtype)


def _bhnd(t):
    return t.detach().float().numpy().transpose(0, 1, 3, 2)


@pytest.mark.parametrize("b,n", [(2, 64), (1, 17), (2, 1), (1, 128)])
def test_plain_version_matches_jax_in_fp32(b, n):
    q, k, v = _inputs(b, n)
    got = FA.flash_cosine_attention(*map(_port, (q, k, v)), SCALE)  # CPU: the plain version
    want = np.asarray(jax_interpret(*map(jnp.asarray, (q, k, v)), SCALE))
    np.testing.assert_allclose(_bhnd(got), want, atol=2e-5, rtol=0)


def test_plain_version_matches_jax_in_bf16():
    q, k, v = _inputs(2, 64, seed=1)
    got = FA.flash_cosine_attention(*(_port(a, torch.bfloat16) for a in (q, k, v)), SCALE)
    assert got.dtype == torch.bfloat16
    want = jax_interpret(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), SCALE)
    assert np.abs(_bhnd(got) - np.asarray(want.astype(jnp.float32))).max() <= 3e-2


def test_vjp_matches_jax():
    q, k, v = _inputs(2, 48, seed=2)
    g = np.random.RandomState(3).randn(*q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_interpret(*a, SCALE), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    leaves = [_port(a).requires_grad_() for a in (q, k, v)]
    FA.flash_cosine_attention(*leaves, SCALE).backward(_port(g))
    for name, t, w in zip("qkv", leaves, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        assert np.abs(_bhnd(t.grad) - w).max() <= 2e-4 * np.abs(w).max(), name


def test_norms_over_d_are_visible():
    """The control of the card check, the norms taken over d instead of N,
    moves the output far beyond the bf16 tolerance, so the check sees which
    axis the kernel normalises."""
    q, k, v = (_port(a) for a in _inputs(2, 256, seed=4))
    base = FA.cosine_attention_reference(q, k, v, SCALE)
    control = FA.cosine_attention_reference(q, k, v, SCALE, norm_dim=2)
    assert (base - control).abs().max() > 0.5


def test_cpu_tensors_take_the_plain_version():
    q, k, v = (_port(a, torch.bfloat16) for a in _inputs(1, 16, seed=5))
    before = FA.flash_cosine_attention.launches
    out = FA.flash_cosine_attention(q, k, v, SCALE)
    assert FA.flash_cosine_attention.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, FA.cosine_attention_reference(q, k, v, SCALE), atol=0, rtol=0)


def test_kernel_checks():
    """The kernel takes q, k, v of one dtype (fp32 or bf16), d = 32, each with
    a batch stride of its own but contiguous inside each image: the three
    chunks of the qkv conv's output go in without a copy."""
    qkv = torch.zeros(2, 3 * 128, 5, 5)
    FA._check(*(t.reshape(2, 4, 32, 25) for t in qkv.chunk(3, dim=1)))
    ok = torch.zeros(2, 4, 32, 25)
    for args, exc in [
        ((ok, ok, ok.bfloat16()), TypeError),
        ((ok.half(), ok.half(), ok.half()), TypeError),
        ((torch.zeros(2, 4, 16, 25),) * 3, ValueError),                      # d != 32
        ((ok, ok, torch.zeros(2, 4, 32, 24)), ValueError),
        ((torch.zeros(2, 4, 25, 32).transpose(2, 3),) * 3, ValueError),      # N strided
    ]:
        with pytest.raises(exc):
            FA._check(*args)


def test_kernel_bound_reads_the_default_unet():
    """Row 5 of PERF.md's table: one call a forward at the 16x16 mid stage
    (N = 256), bound by its fp32 products in either dtype."""
    from tedm_tpu_torch.kernels import bounds

    rows = bounds.kernel_bounds(8)
    for name in ("flash_cosine_attention", "flash_cosine_attention (bf16)"):
        assert rows[name]["calls"] == 1 and rows[name]["bound_by"] == "operations"
        assert rows[name]["bound_ms"] == pytest.approx(1e3 * 4 * 8 * 4 * 256 * 256 * 32 / 67e12)
