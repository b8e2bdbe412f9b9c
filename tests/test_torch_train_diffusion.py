"""The port's backbone trainer against ``tedm_tpu/trainers/diffusion.py``, on the CPU.

One step of the JAX package's jitted ``train_step`` (Adam) and one of the
port's, from the same weights (carried across by ``utils.convert``) and the
same batch, with JAX's t and noise handed to the port: the loss agrees to
1e-5 relative, every gradient to 2e-4 of its tensor's largest entry, and
the parameters after the Adam step to 1e-3 * lr where the gradient is more
than 1e-4 of its tensor's largest entry and more than 100 times Adam's eps
(1e-8), else to 2 * lr. Adam moves a parameter by lr * g / (|g| + eps):
about lr either way for a gradient that is noise, whose sign may differ
between the packages, and by an amount that hangs on the gradient's last
digits where |g| is near eps. The same step under ``--remat`` (both
packages' block checkpointing) is held to the same tolerances. Then, on the port alone: the EMA recurrence and the exact
``--grad_accum`` identity (as ``tests/test_ema.py`` and
``tests/test_grad_accum.py`` pin them for the JAX package), and ``main``
for 2 steps with validation, a resume, and ``load_backbone`` of the written
checkpoint. UNet dim 16, mults (1, 2), 32x32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.models.diffusion import train_loss as jax_train_loss
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu.trainers import diffusion as JD
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.models import unet as U
from tedm_tpu_torch.models.diffusion import train_loss
from tedm_tpu_torch.ops.schedules import make_schedule
from tedm_tpu_torch.trainers import diffusion as D
from tedm_tpu_torch.trainers.common import make_optimizer
from tedm_tpu_torch.trainers.datasetdm import load_backbone
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.utils.checkpoint import load_checkpoint
from tedm_tpu_torch.utils.convert import load_numpy_state_dict, unet_state_dict

torch.set_num_threads(1)

SMALL = dict(experiment="img_only", dim=16, dim_mults=(1, 2), img_size=32, batch_size=4,
             num_workers=1, synthetic_data=True)
ARGS = ["--synthetic_data", "--dim", "16", "--dim_mults", "1", "2", "--img_size", "32",
        "--batch_size", "4", "--timesteps", "20", "--val_steps", "5", "--n_sampled_imgs", "2",
        "--num_workers", "1"]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _batch(n=4, seed=0):
    ds = SyntheticCXRDataset("cxr_train", 16, 32, labelled=False, seed=seed)
    return np.stack([ds[i] for i in range(n)])


def _jax_draws(rng, x):
    """t and noise as the JAX train_loss draws them from ``rng``."""
    t_rng, noise_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (x.shape[0],), 0, 1000)
    return torch.from_numpy(np.array(t)).long(), nchw(jax.random.normal(noise_rng, x.shape, jnp.float32))


def _labelled_batch(n=4, seed=0):
    ds = SyntheticCXRDataset("jsrt_train", 16, 32, labelled=True, seed=seed)
    items = [ds[i] for i in range(n)]
    return {"image": np.stack([img for img, _ in items]), "mask": np.stack([m for _, m in items])}


@pytest.mark.parametrize("experiment", ["img_only", "joint", "joint_and_cond"])
def test_adam_step_matches_jax(experiment):
    """One Adam step of the backbone against JAX's on the same weights, t and
    noise: img_only on an unlabelled batch; joint (x = image and mask, two
    channels) and joint_and_cond (the mask in [-1, 1] concatenated to every
    UNet input) on one labelled batch, each package's ``batch_to_x_cond``."""
    _adam_step_matches_jax(experiment)


def test_remat_adam_step_matches_jax():
    """``--remat``: the port's step, every block's call checkpointed, against
    JAX's step with its blocks under ``nn.remat``, at the same tolerances."""
    _adam_step_matches_jax("img_only", remat=True)


def _adam_step_matches_jax(experiment, remat=False):
    jcfg = JaxConfig(**{**SMALL, "experiment": experiment, "remat": remat})
    junet = JD.build_model(jcfg)
    jsched = jax_make_schedule(jcfg.timesteps, jcfg.beta_schedule)
    params = JD.init_params(jcfg, junet, jax.random.PRNGKey(0))
    params0 = jax.tree_util.tree_map(np.asarray, params)
    cfg = Config(**{**SMALL, "experiment": experiment, "remat": remat})
    if experiment == "img_only":
        x, cond = _batch(), np.zeros((1,), np.float32)
        x_p, cond_p = nchw(x), torch.zeros(1)
    else:
        batch = _labelled_batch()
        x, cond = JD.batch_to_x_cond(jcfg, batch)
        x_p, cond_p = (nchw(a) for a in D.batch_to_x_cond(cfg, batch))
        np.testing.assert_array_equal(x_p.numpy(), nchw(x).numpy())
    conditional = experiment == "joint_and_cond"
    valid = np.array([1, 1, 1, 0], np.float32)
    rng = jax.random.PRNGKey(7)

    def loss_fn(p):
        if conditional:
            apply = lambda xx, tt, **kw: junet.apply({"params": p}, jnp.concatenate([xx, cond], axis=-1), tt, **kw)
        else:
            apply = lambda xx, tt, **kw: junet.apply({"params": p}, xx, tt, **kw)
        return jax_train_loss(apply, jsched, rng, jnp.asarray(x), valid=jnp.asarray(valid))

    grads_j = unet_state_dict(jax.jit(jax.grad(loss_fn))(params))
    tx = optax.adam(jcfg.lr)
    train_step, _, _ = JD.make_steps(jcfg, junet, jsched, tx)
    new_params, _, loss_j, _ = train_step(params, tx.init(params), x, cond, valid, rng)
    after_j = unet_state_dict(new_params)

    before = unet_state_dict(params0)
    unet = load_numpy_state_dict(D.build_model(cfg), before)
    assert junet.remat == unet.remat == remat
    steps = D.make_steps(cfg, unet, make_schedule(cfg.timesteps, cfg.beta_schedule),
                         make_optimizer(cfg, unet.parameters()))
    t, noise = _jax_draws(rng, x)
    loss, _ = steps.train_step(x_p, cond_p, torch.from_numpy(valid), t=t, noise=noise)

    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    lr = cfg.lr
    for name, p in unet.named_parameters():
        g, gj = p.grad.numpy(), grads_j[name]
        gmax = np.abs(gj).max()
        assert np.abs(g - gj).max() <= 2e-4 * gmax, name
        atol = np.where((np.abs(gj) > 1e-4 * gmax) & (np.abs(gj) > 1e-6), 1e-3 * lr, 2 * lr)
        if experiment != "img_only":
            # a gain near 1 rounds its updated value to fp32's spacing there,
            # 1.19e-7, above 1e-3 lr: these cases allow one ulp of the parameter
            # (three gains of the two modes differ by exactly one)
            atol = np.maximum(atol, np.spacing(np.abs(after_j[name])))
        assert (np.abs(p.detach().numpy() - after_j[name]) <= atol).all(), name
        assert np.abs(p.detach().numpy() - before[name]).max() > 0.5 * lr  # it moved


def test_ema_step_recurrence():
    """ema_{k+1} = d * ema_k + (1 - d) * params_{k+1}, from ema_0 = params_0."""
    cfg = Config(**SMALL, ema_decay=0.5, timesteps=20)
    unet = D.build_model(cfg)
    ema = D.build_model(cfg).requires_grad_(False)
    steps = D.make_steps(cfg, unet, make_schedule(cfg.timesteps, cfg.beta_schedule),
                         make_optimizer(cfg, unet.parameters()), ema)
    x, valid = nchw(_batch()), torch.ones(4)
    gen = torch.Generator().manual_seed(0)
    expect = [p.detach().clone() for p in unet.parameters()]
    for _ in range(3):
        steps.train_step(x, torch.zeros(1), valid, generator=gen)
        expect = [e * 0.5 + p.detach() * 0.5 for e, p in zip(expect, unet.parameters())]
        for e, got in zip(expect, ema.parameters()):
            torch.testing.assert_close(got, e, atol=1e-6, rtol=0)
    assert any(not torch.allclose(e, p) for e, p in zip(ema.parameters(), unet.parameters()))


@pytest.mark.parametrize("valid", [[1, 1, 1, 1], [1, 1, 0, 0]])
def test_grad_accum_is_the_global_masked_mean(valid):
    """--grad_accum 2 over batch 4 gives the loss and gradients of the
    global masked mean: an independent loop over the microbatches and one
    step without accumulation agree with it, on the same t and noise, to
    2e-5 of each gradient's largest entry (the sums are taken in another
    order). With [1, 1, 0, 0] the second microbatch is all padding."""
    valid = torch.tensor(valid, dtype=torch.float32)
    x = nchw(_batch())
    gen = torch.Generator().manual_seed(1)
    t, noise = torch.randint(0, 20, (4,), generator=gen), torch.randn(x.shape, generator=gen)

    def step(accum):
        cfg = Config(**SMALL, timesteps=20, grad_accum=accum)
        unet = D.build_model(cfg)
        steps = D.make_steps(cfg, unet, make_schedule(20, "cosine"), make_optimizer(cfg, unet.parameters()))
        loss, _ = steps.train_step(x, torch.zeros(1), valid, t=t, noise=noise)
        return float(loss), [p.grad for p in unet.parameters()]

    # the independent recomputation: per-microbatch losses, weighted by the
    # microbatch's own denominator, over the global valid count
    unet = D.build_model(Config(**SMALL, timesteps=20))
    sched = make_schedule(20, "cosine")
    denom = max(float(valid.sum()), 1.0)
    l_sum, g_sum = 0.0, [torch.zeros_like(p) for p in unet.parameters()]
    for rows in (slice(0, 2), slice(2, 4)):
        loss_i = train_loss(unet, sched, x[rows], t=t[rows], noise=noise[rows], valid=valid[rows])
        w_i = max(float(valid[rows].sum()), 1.0)
        for a, g in zip(g_sum, torch.autograd.grad(loss_i, list(unet.parameters()), allow_unused=True)):
            if g is not None:
                a += w_i * g
        l_sum += w_i * float(loss_i)
    loss2, grads2 = step(2)
    loss1, grads1 = step(1)
    assert abs(loss2 - l_sum / denom) <= 1e-6 * max(abs(l_sum / denom), 1.0)
    assert abs(loss2 - loss1) <= 1e-6 * abs(loss1)
    for g2, g1, g in zip(grads2, grads1, g_sum):
        for other in (g / denom, g1):
            torch.testing.assert_close(g2, other, rtol=0, atol=2e-5 * other.abs().max().item())


def test_main_trains_validates_resumes_and_feeds_the_backbone(tmp_path):
    train_main(["--experiment", "img_only", "--log_dir", str(tmp_path / "bb"), "--ema_decay", "0.9",
                "--max_steps", "2", "--val_freq", "2", "--log_freq", "1", "--max_val_steps", "1"] + ARGS,
               device="cpu")
    run = tmp_path / "CXR14" / "bb"
    best = str(run / "best")
    state, cfg = load_checkpoint(best, verbose=False)
    assert set(state) == {"params", "opt_state", "step", "ema_params"} and state["step"] == 2
    assert cfg.ema_decay == pytest.approx(0.9)
    assert any(not torch.equal(state["params"][k], state["ema_params"][k]) for k in state["params"])
    assert os.path.isfile(run / "images" / "val_samples_2.png")
    with open(run / "metrics.jsonl") as f:
        assert f.read().count("train/loss") == 2

    # a resume continues at step 3 from the saved weights, optimizer and EMA
    train_main(["--experiment", "img_only", "--log_dir", str(tmp_path / "bb2"), "--ema_decay", "0.9",
                "--max_steps", "4", "--val_freq", "2", "--log_freq", "1", "--max_val_steps", "1",
                "--resume_path", best] + ARGS, device="cpu")
    state2, _ = load_checkpoint(str(tmp_path / "CXR14" / "bb2" / "best"), verbose=False)
    assert state2["step"] == 4
    assert state2["opt_state"]["state"][0]["step"] == 4  # Adam's count carried on

    # the head trainers' backbone: the EMA weights, or the raw ones on request
    tedm = Config(log_dir=str(tmp_path / "h")).replace(
        experiment="TEDM", dim=16, dim_mults=(1, 2), img_size=32, saved_diffusion_model=best,
    ).apply_experiment_preset()
    for raw, key in ((False, "ema_params"), (True, "params")):
        unet, sched = load_backbone(tedm.replace(serve_raw_params=raw), device="cpu")
        assert sched.num_timesteps == 20
        for k, v in unet.state_dict().items():
            torch.testing.assert_close(v, state[key][k], atol=0, rtol=0)


@pytest.mark.parametrize(
    "extra,exc,match",
    [
        # the contrastive arms are dispatched, to the card by default
        (["--experiment", "global_finetune"], RuntimeError, "CUDA is not available"),
        (["--experiment", "local_cl"], RuntimeError, "CUDA is not available"),
        (["--experiment", "TEDM", "--grad_accum", "2"], ValueError, "grad_accum"),
        # A.5g's flags are taken, and the run goes to the card by default
        (["--remat"], RuntimeError, "CUDA is not available"),
        (["--profile_dir", "p"], RuntimeError, "CUDA is not available"),
        # A.5h's data axis is taken: FSDP goes to the card by default too
        (["--param_sharding", "fsdp"], RuntimeError, "CUDA is not available"),
        ([], RuntimeError, "CUDA is not available"),  # the card by default, never a CPU fallback
    ],
)
def test_train_main_refuses_what_is_not_ported_and_turns_tf32_off(extra, exc, match, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_bf16_reduced_precision_reduction", True)
    with pytest.raises(exc, match=match):
        train_main(ARGS + ["--log_dir", str(tmp_path / "r")] + extra)
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


FLAGS = {  # flag: (Config field, wrapper in models.unet, the switch on the Unet's modules)
    "--use_pallas_groupnorm": ("use_pallas_groupnorm", "fused_group_norm_film_silu",
                               lambda unet: unet.mid_block1.block1.norm.fused),
    "--use_pallas_resblock": ("use_pallas_resblock", "fused_resnet_block", lambda unet: unet.mid_block1.fused),
    "--use_pallas_flash": ("use_pallas_flash", "flash_cosine_attention", lambda unet: unet.mid_attn.fn.fn.flash),
}


@pytest.mark.parametrize("flag", list(FLAGS))
def test_kernel_flags_reach_the_unet(flag, monkeypatch, tmp_path):
    """``train.main`` takes each opt-in kernel flag (the JAX package's name)
    and its backbone's forward goes through the flag's kernel wrapper, which
    runs the plain version on the CPU; ``load_backbone`` takes the flag from
    the head's config, not the backbone's, as JAX's does
    (tedm_tpu/trainers/datasetdm.py:43-57)."""
    field, wrapper, switch = FLAGS[flag]
    calls = []
    fn = getattr(U, wrapper)
    monkeypatch.setattr(U, wrapper, lambda *a, **k: calls.append(1) or fn(*a, **k))
    train_main(["--experiment", "img_only", "--log_dir", str(tmp_path / "bb"), "--max_steps", "1",
                "--val_freq", "100", "--log_freq", "1", "--ckpt_every", "1", flag] + ARGS, device="cpu")
    assert calls
    saved, cfg = load_checkpoint(str(tmp_path / "CXR14" / "bb" / "step_1"), verbose=False)
    assert getattr(cfg, field) and saved["step"] == 1
    head = Config(log_dir=str(tmp_path / "h")).replace(
        experiment="TEDM", dim=16, dim_mults=(1, 2), img_size=32,
        saved_diffusion_model=str(tmp_path / "CXR14" / "bb" / "step_1"),
    ).apply_experiment_preset()
    for on in (False, True):
        unet, _ = load_backbone(head.replace(**{field: on}), device="cpu")
        assert switch(unet) is on
        assert all(torch.equal(v, saved["params"][k]) for k, v in unet.state_dict().items())
