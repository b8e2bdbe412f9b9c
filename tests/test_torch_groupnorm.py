"""The port's GroupNorm+FiLM+SiLU (kernel B.3) against the JAX package's.

On the CPU the port's wrapper runs its plain version,
``group_norm_film_silu_reference``, which is held here against the Pallas
kernel in interpret mode (``fused_group_norm_film_silu_interpret``) on the
same numpy inputs: fp32 at 2e-5 (KERNELS.json's fp32 forward tolerance),
bf16 at 3e-2 (the bound tests/test_pallas_resblock.py uses; the two round
once, at the output). The analytic VJP that backs the CUDA kernel's
``autograd.Function`` is held against ``jax.vjp`` of the interpret path
(JAX's ``_bwd_jnp``) at 2e-4 of each gradient's largest entry. JAX's layout
is NHWC, the port's NCHW; the tests transpose at the boundary. The CUDA
kernel is held against the plain version on the card by ``chip_smoke.py``;
the checks around it are Python and are tested here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.ops.pallas.groupnorm import fused_group_norm_film_silu_interpret as jax_interpret
from tedm_tpu_torch.kernels import groupnorm as G

torch.set_num_threads(1)


def _inputs(b, c, h, w, seed=0):
    """NHWC x whose channels differ in mean and spread, as a conv's output
    does, and the GroupNorm and FiLM parameters."""
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    x = f(b, h, w, c) * (1 + np.abs(f(c))) + f(c)
    return dict(x=x, gamma=1 + 0.1 * f(c), beta=0.1 * f(c), scale=0.5 * f(b, c), shift=0.5 * f(b, c))


def _port(inp, film, dtype=torch.float32):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    x = t(inp["x"].transpose(0, 3, 1, 2)).to(dtype)
    return x, t(inp["gamma"]), t(inp["beta"]), *(
        (t(inp["scale"]), t(inp["shift"])) if film else (None, None))


def _jax(inp, film, dtype=jnp.float32):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    return (j["x"].astype(dtype), j["gamma"], j["beta"], *((j["scale"], j["shift"]) if film else (None, None)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("film", [True, False])
@pytest.mark.parametrize("shape", [(2, 16, 8, 12), (2, 64, 4, 4), (1, 32, 1, 1)])
def test_plain_version_matches_jax_in_fp32(shape, film):
    inp = _inputs(*shape)
    got = G.fused_group_norm_film_silu(*_port(inp, film))  # CPU: the plain version
    want = np.asarray(jax_interpret(*_jax(inp, film)))
    np.testing.assert_allclose(_nhwc(got), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("film", [True, False])
def test_plain_version_matches_jax_in_bf16(film):
    inp = _inputs(2, 32, 8, 12, seed=1)
    got = G.fused_group_norm_film_silu(*_port(inp, film, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_interpret(*_jax(inp, film, jnp.bfloat16)).astype(jnp.float32))
    assert np.abs(_nhwc(got) - want).max() <= 3e-2


@pytest.mark.parametrize("film", [True, False])
def test_analytic_backward_matches_jax(film):
    inp = _inputs(2, 16, 6, 10, seed=2)
    g = np.random.RandomState(3).randn(2, 6, 10, 16).astype(np.float32)
    args = _jax(inp, film)
    n = 5 if film else 3
    _, vjp = jax.vjp(lambda *a: jax_interpret(*a, *args[n:]), *args[:n])
    want = vjp(jnp.asarray(g))
    got = G.group_norm_film_silu_backward_reference(
        *_port(inp, film), torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 1, 2))))
    assert film or got[3:] == (None, None)
    got = [_nhwc(got[0])] + [t.numpy() for t in got[1:n]]
    for name, a, b in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"), got, want):
        b = np.asarray(b)
        assert a.shape == b.shape and np.abs(b).max() > 0
        assert np.abs(a - b).max() <= 2e-4 * np.abs(b).max(), name


def test_analytic_backward_matches_autograd_of_the_plain_version():
    """The analytic VJP is the gradient of the plain version, in every input,
    with FiLM rows that are strided halves of one (B, 2C) tensor."""
    x, gamma, beta, _, _ = _port(_inputs(2, 16, 5, 7, seed=4), False)
    ss = torch.randn(2, 32, generator=torch.Generator().manual_seed(0))
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta, ss)]
    scale, shift = leaves[3].chunk(2, dim=1)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1))
    G.group_norm_film_silu_reference(leaves[0], leaves[1], leaves[2], scale, shift).backward(g)
    dx, dgamma, dbeta, dscale, dshift = G.group_norm_film_silu_backward_reference(
        x, gamma, beta, *ss.chunk(2, dim=1), g)
    for a, b in zip((dx, dgamma, dbeta, torch.cat([dscale, dshift], dim=1)), (t.grad for t in leaves)):
        torch.testing.assert_close(a, b, atol=2e-5 * b.abs().max().item(), rtol=0)


def test_cpu_tensors_take_the_plain_version():
    args = _port(_inputs(1, 16, 4, 4, seed=5), True, torch.bfloat16)
    before = G.fused_group_norm_film_silu.launches
    out = G.fused_group_norm_film_silu(*args)
    assert G.fused_group_norm_film_silu.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(out, G.group_norm_film_silu_reference(*args), atol=0, rtol=0)


def test_film_rows_pass_the_time_mlp_halves_without_a_copy():
    """The halves of a (B, 2C) tensor go to the kernel as they are, with their
    row stride 2C: fp32 always, bf16 beside a bf16 x; a bf16 row beside an
    fp32 x, or rows of two strides, are made fp32 or contiguous."""
    ss = torch.randn(3, 32)
    scale, shift = ss.chunk(2, dim=1)
    x32, x16 = torch.zeros(3, 16, 2, 2), torch.zeros(3, 16, 2, 2, dtype=torch.bfloat16)
    s, h, stride, bf16 = G.film_rows(scale, shift, x32, 16)
    assert (s.data_ptr(), h.data_ptr(), stride, bf16) == (scale.data_ptr(), shift.data_ptr(), 32, False)
    s16, h16 = ss.bfloat16().chunk(2, dim=1)
    assert G.film_rows(s16, h16, x16, 16)[2:] == (32, True)
    s, h, stride, bf16 = G.film_rows(s16, h16, x32, 16)
    assert s.dtype == h.dtype == torch.float32 and not bf16
    s, h, stride, _ = G.film_rows(scale, shift.contiguous(), x32, 16)
    assert stride == 16 and s.is_contiguous() and h.is_contiguous()
    assert G.film_rows(None, None, x32, 16) == (None, None, 0, False)
    with pytest.raises(ValueError):
        G.film_rows(torch.zeros(2, 16), None, x32, 16)


def test_activation_checks():
    """The kernels take fp32 or bf16 NCHW with any batch stride, contiguous
    inside each image (a channel slice of a wider activation goes in)."""
    wide = torch.zeros(2, 48, 4, 4)
    G.check_activation(wide[:, 16:32], "k")
    for x, exc in [
        (torch.zeros(2, 16, 4, 4, dtype=torch.float16), TypeError),
        (torch.zeros(2, 16, 16), ValueError),
        (torch.zeros(2, 4, 4, 16).permute(0, 3, 1, 2), ValueError),  # channels last
    ]:
        with pytest.raises(exc):
            G.check_activation(x, "k")


def test_kernel_bound_reads_the_default_unet():
    """Row 3 of PERF.md's table: 38 calls a forward (two per ResnetBlock),
    x read and out written, in fp32 and (half the bytes) in bf16."""
    from tedm_tpu_torch.kernels import bounds

    rows = bounds.kernel_bounds(8)
    fp32, bf16 = rows["fused_group_norm_film_silu"], rows["fused_group_norm_film_silu (bf16)"]
    assert fp32["calls"] == bf16["calls"] == 38
    _, res = bounds.unet_stages()
    by_bytes = sum(2 * 2 * 4 * 8 * c_out * s * s for _, c_out, s in res) / 3.35e12
    assert fp32["bound_ms"] == pytest.approx(1e3 * by_bytes)
    assert bf16["bound_ms"] == pytest.approx(fp32["bound_ms"] / 2)
