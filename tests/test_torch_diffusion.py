"""The port's DDPM functions against ``tedm_tpu/models/diffusion.py``, on the CPU.

The model is a fixed elementwise function of (x_t, t), the same in both
packages, so these tests hold the diffusion arithmetic alone (the UNet is
held elsewhere). The JAX functions draw t and noise from split PRNG keys;
each test redraws them exactly as the JAX function does and hands them to
the port. Tolerance 2e-4, fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.models import diffusion as JD
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu_torch.models import diffusion as D
from tedm_tpu_torch.ops.schedules import make_schedule

torch.set_num_threads(1)

TOL = 2e-4
T = 1000


def _model(xp):
    """(x_t, t) -> a bounded nonlinear output; x_t NHWC or NCHW alike."""
    def apply(x, t, **kw):
        return xp.tanh(1.5 * x) * 0.8 + 1e-3 * t.reshape(-1, 1, 1, 1)
    return apply


jax_apply, torch_apply = _model(jnp), _model(torch)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _x(n=3, size=16, c=1, seed=0):
    return np.random.RandomState(seed).rand(n, size, size, c).astype(np.float32)


@pytest.mark.parametrize("gamma,channels", [(0.0, 1), (0.5, 1), (0.5, 2)])
def test_train_loss_with_jax_draws(gamma, channels):
    x = _x(c=channels)
    valid = np.array([1, 1, 0], np.float32)
    rng = jax.random.PRNGKey(3)
    jsched = jax_make_schedule(T, "cosine", gamma)
    aux = channels > 1
    want = JD.train_loss(jax_apply, jsched, rng, jnp.asarray(x), valid=jnp.asarray(valid),
                         aux_channel_losses=aux)
    t_rng, noise_rng = jax.random.split(rng)  # as train_loss draws them
    t = jax.random.randint(t_rng, (x.shape[0],), 0, T)
    noise = jax.random.normal(noise_rng, x.shape, jnp.float32)
    got = D.train_loss(torch_apply, make_schedule(T, "cosine", gamma), nchw(x),
                       t=torch.from_numpy(np.array(t)).long(), noise=nchw(noise),
                       valid=torch.from_numpy(valid), aux_channel_losses=aux)
    if not aux:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    assert float(got[0]) > 0.1  # not vacuous


def test_train_loss_draws_from_the_generator():
    sched = make_schedule(T, "cosine")
    x = nchw(_x())
    a = D.train_loss(torch_apply, sched, x, generator=torch.Generator().manual_seed(5))
    b = D.train_loss(torch_apply, sched, x, generator=torch.Generator().manual_seed(5))
    c = D.train_loss(torch_apply, sched, x, generator=torch.Generator().manual_seed(6))
    assert a == b and a != c
    with pytest.raises(ValueError):
        D.train_loss(torch_apply, sched, x)


def test_val_loss_with_jax_draws():
    x = _x(n=2)
    valid = np.array([1, 0], np.float32)
    rng = jax.random.PRNGKey(4)
    t_steps, fold = 20, 8  # 20 timesteps: 3 chunks of 8, the last padded
    want = JD.val_loss(jax_apply, jax_make_schedule(T, "cosine", 0.5), rng, jnp.asarray(x),
                       t_steps, fold_batch=fold, valid=jnp.asarray(valid))
    n_chunks = -(-t_steps // fold)
    noise = [nchw(jax.random.normal(r, (fold * x.shape[0], *x.shape[1:]), jnp.float32))
             for r in jax.random.split(rng, n_chunks)]
    got = D.val_loss(torch_apply, make_schedule(T, "cosine", 0.5), nchw(x), t_steps, noise=noise,
                     fold_batch=fold, valid=torch.from_numpy(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_q_posterior_and_predictions():
    rs = np.random.RandomState(1)
    x0, xt = (rs.randn(4, 8, 8, 1).astype(np.float32) for _ in range(2))
    t = np.array([0, 1, 500, 999])
    jsched, sched = jax_make_schedule(T, "cosine"), make_schedule(T, "cosine")
    jt, tt = jnp.asarray(t), torch.from_numpy(t)
    (mean_j, log_var_j) = JD.q_posterior(jsched, jnp.asarray(x0), jnp.asarray(xt), jt)
    mean, log_var = D.q_posterior(sched, nchw(x0), nchw(xt), tt)
    np.testing.assert_allclose(mean.numpy(), nchw(mean_j).numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(log_var.numpy().ravel(), np.asarray(log_var_j).ravel(), atol=TOL, rtol=0)
    for objective in ("pred_noise", "pred_x_0"):
        want = JD.model_predictions(jax_apply, jsched, jnp.asarray(xt), jt, objective)
        got = D.model_predictions(torch_apply, sched, nchw(xt), tt, objective)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), nchw(w).numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size,percentile", [(32, 0.995), (128, 0.995), (32, 0.3)])
def test_dynamic_threshold(size, percentile):
    """0.995 takes the top-k path, 0.3 the full quantile; rows of 32² and 128²."""
    x = (np.random.RandomState(size).randn(3, size, size, 1) * 1.5).astype(np.float32)
    x[2] *= 0.2  # a row whose quantile is under 1: the floor at 1 holds it
    want = JD.dynamic_threshold(jnp.asarray(x), percentile)
    got = D.dynamic_threshold(nchw(x), percentile)
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), atol=TOL, rtol=0)
    assert np.abs(got.numpy()).max() <= 1.0


def test_sample_step_with_jax_noise():
    rs = np.random.RandomState(2)
    xt = rs.randn(3, 16, 16, 1).astype(np.float32)
    t = np.array([0, 7, 640])  # t = 0 takes no noise
    rng = jax.random.PRNGKey(9)
    want = JD.sample_step(jax_apply, jax_make_schedule(T, "cosine"), rng, jnp.asarray(xt), jnp.asarray(t))
    noise = jax.random.normal(rng, xt.shape, jnp.float32)  # as sample_step draws it
    got = D.sample_step(torch_apply, make_schedule(T, "cosine"), nchw(xt), torch.from_numpy(t),
                        noise=nchw(noise))
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), atol=TOL, rtol=0)


def test_sample_loop_snapshots():
    """The reference's snapshot slots: slot i holds the sample after the step
    at t = i * (T // n); slot 0 is the final sample; a seed fixes the run."""
    sched = make_schedule(20, "cosine")
    gen = lambda: torch.Generator().manual_seed(0)
    x0, snaps = D.sample_loop_with_snapshots(torch_apply, sched, (2, 1, 8, 8), gen(), n_snapshots=4)
    assert snaps.shape == (4, 2, 1, 8, 8) and torch.isfinite(snaps).all()
    torch.testing.assert_close(snaps[0], x0, atol=0, rtol=0)
    assert not torch.allclose(snaps[3], snaps[0])
    torch.testing.assert_close(D.sample_loop(torch_apply, sched, (2, 1, 8, 8), gen()), x0, atol=0, rtol=0)
