"""The linear-attention forward kernel's passes (B.1), in plain PyTorch, against the JAX package.

The CUDA forward cuts each (b, h)'s N columns into shares, one a block; each
warp of a block folds its 16-column slices into an online-softmax partial
(the row max m of k, l = sum exp(k - m), P = sum exp(k - m) v^T); the warps'
partials are merged in warp order, the shares' in share order, into scale*C
and the statistics (m, l) that the backward reads, and the context is
applied to softmax_d(q).
``linear_attention_forward_passes`` is that computation in plain PyTorch;
the tests hold it, with shares that split N unevenly, against the JAX
package's reference and the Pallas forward kernel in interpret mode
(``_fwd_kernel``) at 2e-5 absolute (KERNELS.json's fp32 forward tolerance),
and its saved tensors against ``linear_attention_saved_reference`` at 1e-6
of their largest entry, inputs from a numpy seed, with its products in fp32
and emulated in split TF32 as the kernel's tensor cores compute them. At N =
1 the backward's dk vanishes only if scale*C is (scale / N) v bit for bit;
the kernel adds each warp's first column by an fmaf for that, not on the
tensor cores, and the tests hold the emulation to it. The kernel itself is
held against these functions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.ops.pallas.linear_attention import linear_attention_interpret as jax_la_interpret
from tedm_tpu.ops.pallas.linear_attention import linear_attention_reference as jax_la_reference
from tedm_tpu_torch.kernels import linear_attention as la
from tedm_tpu_torch.kernels.tf32 import split_matmul

torch.set_num_threads(1)

SCALE = 32 ** -0.5
TOL = 2e-5
SAVED_TOL = 1e-6
# (N, share): one column; shares that split N unevenly, neither a whole number of 128-column tiles
CASES = [(1, 16), (300, 112), (1024, 400)]


def _qkv(n, seed):
    """B = 2, h = 4, d = 32; v carries the factor N that the math divides
    out, so that the outputs are O(0.1) at every N."""
    rs = np.random.RandomState(seed)
    q, k = [(rs.randn(2, 4, 32, n) * 2).astype(np.float32) for _ in range(2)]
    return q, k, (rs.randn(2, 4, 32, n) * n).astype(np.float32)


def _passes(q, k, v, share, tf32):
    return la.linear_attention_forward_passes(*map(torch.from_numpy, (q, k, v)), SCALE, share, tf32)


@pytest.mark.parametrize("tf32", [False, True], ids=["fp32", "split_tf32"])
@pytest.mark.parametrize("n,share", CASES)
def test_passes_match_the_jax_reference(n, share, tf32):
    q, k, v = _qkv(n, seed=n)
    want = np.asarray(jax_la_reference(*map(jnp.asarray, (q, k, v)), SCALE))
    out = _passes(q, k, v, share, tf32)[0].numpy()
    assert out.shape == want.shape
    assert np.abs(out - want).max() <= TOL


@pytest.mark.parametrize("tf32", [False, True], ids=["fp32", "split_tf32"])
@pytest.mark.parametrize("n,share", CASES)
def test_passes_match_the_pallas_fwd_kernel(n, share, tf32):
    q, k, v = _qkv(n, seed=100 + n)
    want = np.asarray(jax_la_interpret(*map(jnp.asarray, (q, k, v)), SCALE))
    assert np.abs(_passes(q, k, v, share, tf32)[0].numpy() - want).max() <= TOL


@pytest.mark.parametrize("tf32", [False, True], ids=["fp32", "split_tf32"])
@pytest.mark.parametrize("n,share", CASES)
def test_saved_tensors_match_the_plain_version(n, share, tf32):
    """scale*C and softmax_N(k)'s row max and sum, as the merged partials
    give them, against ``linear_attention_saved_reference``."""
    q, k, v = _qkv(n, seed=200 + n)
    _, ctx, stats = _passes(q, k, v, share, tf32)
    want_ctx, want_stats = la.linear_attention_saved_reference(*map(torch.from_numpy, (q, k, v)), SCALE)
    for got, want in ((ctx, want_ctx), (stats[:, 0], want_stats[:, 0]), (stats[:, 1], want_stats[:, 1])):
        assert got.shape == want.shape
        assert (got - want).abs().max() <= SAVED_TOL * want.abs().max()


def test_one_column_gives_the_context_exactly_and_dk_zero():
    """At N = 1, p = 1 and scale*C[d][e] = (scale / N) v[e]: the first
    column taken by an fmaf gives v, so the saved context is scale*v bit for
    bit, and the backward's two passes on it give dk = 0 exactly."""
    q, k, v = _qkv(1, seed=11)
    g = np.random.RandomState(12).randn(2, 4, 32, 1).astype(np.float32)
    _, ctx, stats = _passes(q, k, v, 16, tf32=True)
    vt = torch.from_numpy(v).reshape(8, 1, 32)
    assert torch.equal(ctx, (vt * SCALE).expand(8, 32, 32))
    t = [torch.from_numpy(a) for a in (q, k, v, g)]
    _, dk, _ = la.linear_attention_backward_passes(*t, ctx, stats, SCALE, tf32=True)
    assert not dk.any()


def test_split_tf32_product_of_one_drops_low_bits_of_v():
    """Why the first column is not taken on the tensor cores: the split-TF32
    product of 1 and v is hi + lo of v's split, 22 of its 24 bits."""
    v = torch.from_numpy((np.random.RandomState(13).randn(1, 4096) * 300).astype(np.float32))
    got = split_matmul(torch.ones(1, 1), v)
    assert not torch.equal(got, v)
    assert (got - v).abs().max() <= 2 ** -21 * v.abs().max()
