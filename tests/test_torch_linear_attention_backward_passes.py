"""The linear-attention backward kernel's two passes (B.1b), in plain PyTorch, against the JAX package.

The CUDA backward runs as two passes: one reads q and g (and the forward's
saved scale*C) and writes dq, dC' and r; the other reads k and v (and the
forward's softmax_N statistics, dC' and r) and writes dk and dv.
``linear_attention_backward_pass_q`` and ``linear_attention_backward_pass_kv``
are those passes in plain PyTorch, each taking only what its pass reads; the
tests hold them, on the forward's saved tensors
(``linear_attention_saved_reference``), against the plain analytic backward
and against ``jax.vjp`` through the Pallas kernel in interpret mode (which
runs ``_bwd_kernel``), at 2e-4 (KERNELS.json's fp32 VJP tolerance) of each
gradient's largest entry, floored at 1e-3 as ``chip_smoke.py`` floors it, so
that a gradient that vanishes (N = 1) is held to 2e-7. Inputs come from a
numpy seed. The same passes with their tensor-core products emulated in
split TF32 are held to the same gate. The kernel itself is held against
these functions on the card by ``chip_smoke.py``.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.ops.pallas.linear_attention import linear_attention_interpret as jax_la_interpret
from tedm_tpu_torch.kernels import linear_attention as la

torch.set_num_threads(1)

SCALE = 32 ** -0.5
TOL = 2e-4


def _qkvg(n, seed):
    """B = 2, h = 4, d = 32; v carries the factor N that the math divides
    out, so that no gradient is small by construction."""
    rs = np.random.RandomState(seed)
    q, k, g = [(rs.randn(2, 4, 32, n) * 2).astype(np.float32) for _ in range(3)]
    return q, k, (rs.randn(2, 4, 32, n) * n).astype(np.float32), g


def _assert_grads_close(got, want):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = np.asarray(a, dtype=np.float32), np.asarray(b, dtype=np.float32)
        assert a.shape == b.shape
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-3)
        assert err <= TOL, (name, err)


def _passes(q, k, v, g, tf32):
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    ctx, stats = la.linear_attention_saved_reference(t[0], t[1], t[2], SCALE)
    return [x.numpy() for x in la.linear_attention_backward_passes(*t, ctx, stats, SCALE, tf32=tf32)]


@pytest.mark.parametrize("tf32", [False, True], ids=["fp32", "split_tf32"])
@pytest.mark.parametrize("n", [1, 300, 513, 1024])
def test_passes_match_the_plain_backward(n, tf32):
    q, k, v, g = _qkvg(n, seed=n)
    want = la.linear_attention_backward_reference(*map(torch.from_numpy, (q, k, v, g)), SCALE)
    _assert_grads_close(_passes(q, k, v, g, tf32), [w.numpy() for w in want])


@pytest.mark.parametrize("tf32", [False, True], ids=["fp32", "split_tf32"])
@pytest.mark.parametrize("n", [1, 300, 513, 1024])
def test_passes_match_the_pallas_bwd_kernel(n, tf32):
    q, k, v, g = _qkvg(n, seed=100 + n)
    _, vjp = jax.vjp(lambda a, b, c: jax_la_interpret(a, b, c, SCALE), *map(jnp.asarray, (q, k, v)))
    _assert_grads_close(_passes(q, k, v, g, tf32), vjp(jnp.asarray(g)))


@pytest.mark.parametrize("n", [1, 513])
def test_saved_tensors_match_jax(n):
    """scale*C and softmax_N(k)'s row max and sum, as the forward kernel
    saves them, against the same quantities in jnp."""
    q, k, v, _ = _qkvg(n, seed=7)
    ctx, stats = la.linear_attention_saved_reference(*map(torch.from_numpy, (q, k, v)), SCALE)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    m = jnp.max(jk, axis=3)
    l = jnp.sum(jnp.exp(jk - m[..., None]), axis=3)
    want = jnp.einsum("bhdn,bhen->bhde", jax.nn.softmax(jk, axis=3), jv / n) * SCALE
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want).reshape(8, 32, 32), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(stats[:, 0].numpy(), np.asarray(m).reshape(8, 32), rtol=0, atol=0)
    np.testing.assert_allclose(stats[:, 1].numpy(), np.asarray(l).reshape(8, 32), rtol=1e-6)


def test_dk_vanishes_exactly_at_one_column():
    """At N = 1 softmax_N(k) is 1, dp = r and dk = p (dp - r) is 0 in exact
    arithmetic. Pass 2 sums dp over e in the order pass 1 sums r, from
    operands that are then equal bit for bit, so dk is 0 here too, not the
    rounding noise of two orders of summation."""
    q, k, v, g = _qkvg(1, seed=11)
    for tf32 in (False, True):
        assert not np.any(_passes(q, k, v, g, tf32)[1])


def test_each_pass_takes_only_what_it_reads():
    assert list(inspect.signature(la.linear_attention_backward_pass_q).parameters) == ["q", "g", "ctx", "tf32"]
    assert list(inspect.signature(la.linear_attention_backward_pass_kv).parameters) == [
        "k", "v", "m", "l", "dctx", "r", "scale", "tf32"]


def test_split_tf32_products_differ_from_fp32_but_hold_the_gate():
    """The emulation is not the fp32 product: split TF32 drops lo*lo and
    rounds the lo parts, some 2**-22 of each term, so the two differ by a
    few ulp; both are within the gate of the plain backward."""
    q, k, v, g = _qkvg(300, seed=5)
    a, b = _passes(q, k, v, g, False), _passes(q, k, v, g, True)
    assert any(np.any(x != y) for x, y in zip(a, b))
    for x, y in zip(a, b):
        assert np.abs(x - y).max() <= 1e-5 * np.abs(x).max()
