"""The port's DDIM and DPM-Solver++(2M) samplers and the conditional eval
chain against ``tedm_tpu/models/diffusion.py`` and ``tedm_tpu/eval/harness.py``,
on the CPU.

The step grids against ``jnp.linspace(0, T-1, n).round()`` for T = 50 and
1000 and n from 2 to 40, 50, 51, 100, 101, 200 and 1000. A conditional UNet (dim 16, mults (1, 2),
32x32, batch 2; T = 50) carried from JAX by ``utils.convert``: DDIM at eta
0 and 0.5 and DPM++(2M), 5 steps, from JAX's x_T and step noises rebuilt
from its key, to 1e-4 absolute; ``predict_conditional_dataset`` on one
batch (a padding row, 5 runs of DDIM) with the same draws, to 1e-4.
``load_diffusion_experiment`` serves the EMA weights unless
``serve_raw_params``. ``train.main --experiment conditional`` then
``run_tests --ddim_steps 3`` writes the four npz files.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.eval import harness as jh
from tedm_tpu.models import diffusion as jd
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu.trainers import diffusion as jtrain
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.eval import harness, run_tests
from tedm_tpu_torch.models import diffusion as td
from tedm_tpu_torch.ops.schedules import make_schedule
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.trainers.diffusion import build_model
from tedm_tpu_torch.utils.checkpoint import save_checkpoint
from tedm_tpu_torch.utils.convert import load_numpy_state_dict, unet_state_dict

torch.set_num_threads(1)

T, STEPS, SIZE = 50, 5, 32
KW = dict(experiment="conditional", dim=16, dim_mults=(1, 2), img_size=SIZE, batch_size=2, num_workers=1,
          synthetic_data=True, timesteps=T, ddim_steps=STEPS)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def jax_draws(key, shape, steps):
    """x_T and the per-step noises that JAX's DDIM draws from ``key``
    (tedm_tpu/models/diffusion.py:260-263), NCHW."""
    rng, init = jax.random.split(key)
    return nchw(jax.random.normal(init, shape)), [nchw(jax.random.normal(r, shape))
                                                  for r in jax.random.split(rng, steps)]


@pytest.mark.parametrize("timesteps", [50, 1000])
def test_step_grid_matches_jax(timesteps):
    for n in list(range(2, 41)) + [50, 51, 100, 101, 200, 1000]:
        want = np.asarray(jnp.linspace(0.0, timesteps - 1, n).round().astype(jnp.int32)[::-1]).tolist()
        assert td.step_grid(timesteps, n) == want, n


@pytest.fixture(scope="module")
def conditional(tmp_path_factory):
    """The JAX conditional UNet (perturbed, so that the samples spread), its
    port, the schedules and a condition of two synthetic images in [-1, 1]."""
    jcfg = JaxConfig(**KW, log_dir=str(tmp_path_factory.mktemp("c") / "run")).apply_experiment_preset()
    junet = jtrain.build_model(jcfg)
    rs = np.random.RandomState(0)
    params = jax.tree_util.tree_map(lambda p: np.array(p) + 0.05 * rs.randn(*np.shape(p)).astype(np.float32),
                                    jtrain.init_params(jcfg, junet, jax.random.PRNGKey(0)))
    cfg = Config(**KW, log_dir=jcfg.log_dir).apply_experiment_preset()
    unet = load_numpy_state_dict(build_model(cfg), unet_state_dict(params)).eval()
    ds = SyntheticCXRDataset("val", 2, SIZE, labelled=True, seed=0)
    img, mask = (np.stack(a) for a in zip(*(ds[i] for i in range(2))))
    return dict(jcfg=jcfg, junet=junet, params=params, cfg=cfg, unet=unet, img=img, mask=mask,
                jsched=jax_make_schedule(T, "cosine"), sched=make_schedule(T, "cosine"))


@pytest.mark.parametrize("sampler,eta", [("ddim", 0.0), ("ddim", 0.5), ("dpmpp2m", None)])
def test_samplers_match_jax(conditional, sampler, eta):
    c = conditional
    cond = c["img"] * 2.0 - 1.0
    shape = (2, SIZE, SIZE, 1)
    key = jax.random.PRNGKey(11)
    japply = lambda x, t: c["junet"].apply({"params": c["params"]}, jnp.concatenate([x, cond], -1), t)
    tcond = nchw(cond)
    tapply = lambda x, t: c["unet"](torch.cat([x, tcond], dim=1), t)
    x_T, noises = jax_draws(key, shape, STEPS)
    if sampler == "ddim":
        want = jax.jit(lambda k: jd.ddim_sample_loop(japply, c["jsched"], k, shape, num_steps=STEPS, eta=eta))(key)
        got = td.ddim_sample_loop(tapply, c["sched"], (2, 1, SIZE, SIZE), num_steps=STEPS, eta=eta, x_T=x_T,
                                  noises=noises)
    else:
        want = jax.jit(lambda k: jd.dpmpp2m_sample_loop(japply, c["jsched"], k, shape, num_steps=STEPS))(key)
        got = td.dpmpp2m_sample_loop(tapply, c["sched"], (2, 1, SIZE, SIZE), num_steps=STEPS, x_T=x_T)
    want = nchw(want).numpy()
    assert got.shape == want.shape and np.isfinite(got.numpy()).all()
    assert want.std() > 0.1
    if sampler == "ddim":  # its last step lands on the thresholded x_0
        assert np.abs(want).max() <= 1.0 + 1e-6
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_predict_conditional_dataset_matches_jax(conditional):
    c = conditional
    batch = {"image": c["img"], "mask": c["mask"], "valid": np.array([1, 0], np.float32)}
    key = jax.random.PRNGKey(3)
    want, want_star = jh.predict_conditional_dataset(c["jcfg"], c["params"], c["junet"], c["jsched"], [batch], key)
    draws, rng = [], key
    for _ in range(5):  # as JAX splits its key a run
        rng, sub = jax.random.split(rng)
        draws.append(jax_draws(sub, (2, SIZE, SIZE, 1), STEPS))
    got, star = harness.predict_conditional_dataset(c["cfg"], c["unet"], c["sched"].to("cpu"), [batch], draws=draws)
    assert got.shape == (1, SIZE, SIZE, 1) and np.array_equal(star, want_star)
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=0)


def test_load_diffusion_experiment_serves_ema_unless_raw(conditional, tmp_path):
    c = conditional
    raw = c["unet"].state_dict()
    ema = {k: v + 1.0 if v.is_floating_point() else v for k, v in raw.items()}
    for serve_raw in (False, True):
        cfg = c["cfg"].replace(log_dir=str(tmp_path / str(serve_raw)), serve_raw_params=serve_raw)
        save_checkpoint(os.path.join(cfg.log_dir, "best"), {"params": raw, "ema_params": ema, "step": 1}, cfg)
        got_cfg, unet, sched = harness.load_diffusion_experiment(cfg.log_dir, device="cpu")
        assert got_cfg.experiment == "conditional" and sched.num_timesteps == T and not unet.training
        want = raw if serve_raw else ema
        for k, v in unet.state_dict().items():
            torch.testing.assert_close(v, want[k], atol=0, rtol=0)


def test_conditional_chain_through_train_main(tmp_path):
    logs = tmp_path / "logs"
    train_main(["--experiment", "conditional", "--synthetic_data", "--dim", "8", "--dim_mults", "1", "2",
                "--img_size", "16", "--batch_size", "4", "--num_workers", "1", "--timesteps", "20",
                "--max_steps", "2", "--val_freq", "2", "--log_freq", "1", "--max_val_steps", "1", "--val_steps", "5",
                "--n_sampled_imgs", "2", "--ema_decay", "0.9", "--log_dir", str(logs / "run")], device="cpu")
    exp_dir = logs / "conditional" / "None" / "run"
    out = run_tests.evaluate_experiment(str(exp_dir), device="cpu", ddim_steps=3)
    sizes = {"JSRT_val": 25, "JSRT_test": 25, "NIH": 100, "Montgomery": 100}
    assert sorted(out) == sorted(sizes)
    for key, n in sizes.items():
        assert os.path.isfile(exp_dir / f"{key}_predictions.npz")
        y = out[key]["y_hat"]
        assert y.shape == (n, 16, 16, 1) and 0.0 <= y.min() and y.max() <= 1.0
        assert out[key]["dice"].shape == (n, 1)
