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
here, with the kernel's arithmetic emulated in plain PyTorch against the
2e-5 gate (split TF32 for fp32 inputs, two bf16 parts of q and P for bf16
ones; one product of the rounded operands, the control, misses it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.ops.pallas.flash_attention import flash_cosine_attention_interpret as jax_interpret
from tedm_tpu_torch.kernels import flash_attention as FA
from tedm_tpu_torch.kernels import resblock as RB

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
    (N = 256). In fp32 its products bound it, three TF32 products each; in
    bf16, at two bf16 products each, the bytes of q, k, v and out do."""
    from tedm_tpu_torch.kernels import bounds

    rows = bounds.kernel_bounds(8)
    flops, elems = 4 * 8 * 4 * 256 * 256 * 32, 4 * 8 * 4 * 32 * 256
    fp32, bf16 = rows["flash_cosine_attention"], rows["flash_cosine_attention (bf16)"]
    assert fp32["calls"] == bf16["calls"] == 1
    assert fp32["bound_by"] == "operations" and fp32["bound_ms"] == pytest.approx(1e3 * flops / (495e12 / 3))
    assert bf16["bound_by"] == "bytes" and bf16["bound_ms"] == pytest.approx(1e3 * 2 * elems / 3.35e12)
    assert 1e3 * flops / (989e12 / 2) < bf16["bound_ms"]


def _bf16_split(t):
    """(hi, lo) with t = hi + lo to 2**-16 of |t|, as the kernel splits an
    fp32 operand of a bf16 product (csrc/tensor_core.cuh split_bf16x2): hi
    the upper 16 bits of t's fp32 bits (truncated), lo the rest rounded to
    bf16."""
    bits = t.float().contiguous().view(torch.int32)
    hi = (bits & -0x10000).view(torch.float32)
    return hi, (t.float() - hi).bfloat16().float()


def _kernel_route(q, k, v, scale, single_pass=False):
    """The kernel's arithmetic in plain PyTorch: scale / (|q_d| |k_d|)
    folded into q, then S = q^T k and P v with fp32 sums. fp32 inputs:
    split-TF32 products (lo*hi + hi*lo + hi*hi). bf16 inputs: k and v exact
    in bf16, the folded q and P as two bf16 parts (lo*k + hi*k). Or one
    product each of the rounded operands (a control)."""
    bf16 = q.dtype == torch.bfloat16
    q, k, v = q.float(), k.float(), v.float()
    nq, nk = (t.norm(dim=-1, keepdim=True).clamp_min(1e-12) for t in (q, k))
    qf = q * (scale / (nq * nk))

    def mm(eq, a, b):
        if bf16:
            (ah, al), bh = _bf16_split(a), b
            return torch.einsum(eq, ah, bh) if single_pass else torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bh)
        (ah, al), (bh, bl) = RB.tf32_split(a), RB.tf32_split(b)
        if single_pass:
            return torch.einsum(eq, ah, bh)
        return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)

    s = mm("bhdi,bhdj->bhij", qf, k)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return mm("bhij,bhdj->bhdi", p, v) / p.sum(dim=-1).unsqueeze(2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_route_holds_the_fp32_gate_at_n_256(dtype):
    """At the path's shape (8, 4, 32, 256), on the card check's inputs, the
    kernel's route agrees with the fp32 plain version on the same values
    within the 2e-5 gate: split TF32 for fp32 inputs, two bf16 parts of q
    and P for bf16 ones (before the output's rounding to bf16); one product
    of the rounded operands each (the control) does not."""
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in np.random.RandomState(7).randn(3, 8, 4, 32, 256).astype(np.float32))
    want = FA.cosine_attention_reference(q.float(), k.float(), v.float(), SCALE)
    split = (_kernel_route(q, k, v, SCALE) - want).abs().max().item()
    single = (_kernel_route(q, k, v, SCALE, single_pass=True) - want).abs().max().item()
    assert split <= 2e-5 < single, (split, single)


def test_bf16_inputs_need_two_products():
    """bf16 k and v are exact in bf16 and in TF32 (lo = 0): for them the
    kernel's two products (q_lo k + q_hi k, and P likewise) give what three
    would, bit for bit."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in np.random.RandomState(8).randn(3, 2, 4, 32, 64).astype(np.float32))
    for t in (k, v):
        for hi, lo in (RB.tf32_split(t.float()), _bf16_split(t)):
            assert torch.equal(hi, t.float()) and not lo.any()
    qh, ql = _bf16_split(q.float() * 0.37)
    kh, kl = _bf16_split(k)
    three = torch.einsum("bhdi,bhdj->bhij", ql, kh) + torch.einsum("bhdi,bhdj->bhij", qh, kl) \
        + torch.einsum("bhdi,bhdj->bhij", qh, kh)
    two = torch.einsum("bhdi,bhdj->bhij", ql, kh) + torch.einsum("bhdi,bhdj->bhij", qh, kh)
    assert torch.equal(three, two)
