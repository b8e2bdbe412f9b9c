"""The port's PDDM probe and trainer against ``tedm_tpu/models/segmentation.py``
(``LinearProbe``, ``masked_feature_sums``, ``feature_moments``) and
``tedm_tpu/trainers/per_step.py``, on the CPU.

The probe's forward on the same features (two timesteps, stage widths
(32, 16), a padding row) agrees with JAX's to 2e-4 of the largest logit with
and without standardisation; the masked sums and the moments to 1e-5
relative. One training step of the PDDM task (UNet dim 16, mults (1, 2),
32x32, the JAX task's backbone, probe and standardisation statistics carried
across by ``utils.convert``, JAX's feature noise) agrees at the tolerances
of ``test_torch_train_segmentation.py``. The port's standardisation
pre-pass equals the moments of the features it drew, padding rows left out
(its noise replayed from the seed). Also: ``train.main`` for PDDM, then
``run_tests`` and ``Predictor("PDDM")``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.data.pipeline import build_dataloaders as jax_build_dataloaders
from tedm_tpu.models.segmentation import LinearProbe as JaxLinearProbe
from tedm_tpu.models.segmentation import feature_moments as jax_feature_moments
from tedm_tpu.models.segmentation import masked_feature_sums as jax_masked_feature_sums
from tedm_tpu.trainers.common import make_train_step as jax_make_train_step
from tedm_tpu.trainers.per_step import build_task as jax_build_task
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.data.pipeline import build_dataloaders
from tedm_tpu_torch.eval import run_tests
from tedm_tpu_torch.models.segmentation import LinearProbe, extract_features, feature_moments, masked_feature_sums
from tedm_tpu_torch.serve.app import Predictor
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.trainers import per_step
from tedm_tpu_torch.trainers.common import make_optimizer, make_train_step, to_nchw
from tedm_tpu_torch.utils.checkpoint import load_checkpoint
from tedm_tpu_torch.utils.convert import load_numpy_state_dict, probe_state_dict, task_state_dicts

torch.set_num_threads(1)

STAGES, STEPS, B, SIZE = (32, 16), 2, 3, 32
SMALL = dict(dim=16, dim_mults=(1, 2), img_size=SIZE, batch_size=2, num_workers=1, synthetic_data=True,
             n_labelled_images=3, lr=1e-3, experiment="PDDM", t_steps_to_save=(1, 200))


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _feats(rs):
    """NHWC features of two timesteps folded step-major: 16^2 and 32^2 stages."""
    return [(rs.randn(STEPS * B, s, s, c) * 2 + 0.5).astype(np.float32) for s, c in ((16, 32), (32, 16))]


@pytest.mark.parametrize("standardize", [False, True])
def test_linear_probe_matches_jax(standardize):
    rs = np.random.RandomState(0)
    feats = _feats(rs)
    jprobe = JaxLinearProbe(stage_channels=STAGES, n_steps=STEPS, img_size=SIZE, standardize=standardize)
    variables = jprobe.init(jax.random.PRNGKey(0), feats)
    params = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.1 * rs.randn(*p.shape).astype(np.float32),
                                    variables["params"])
    c_in = sum(STAGES) * STEPS
    stats = {"mean": rs.randn(c_in).astype(np.float32), "std": (0.5 + rs.rand(c_in)).astype(np.float32)}
    want = np.asarray(jprobe.apply({"params": params, "stats": stats}, feats))

    probe = LinearProbe(stage_channels=STAGES, n_steps=STEPS, img_size=SIZE, standardize=standardize)
    assert probe.weight.shape == (1, c_in, 1, 1) and not probe.bias.any() and probe.std.eq(1).all()
    load_numpy_state_dict(probe, probe_state_dict(params, stats))
    got = probe([nchw(f) for f in feats]).detach()
    assert got.shape == (B, 1, SIZE, SIZE)
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), atol=2e-4 * np.abs(want).max(), rtol=0)


def test_feature_sums_and_moments_match_jax():
    rs = np.random.RandomState(1)
    feats = _feats(rs)
    valid = np.array([1, 1, 0], np.float32)
    got = masked_feature_sums([nchw(f) for f in feats], STEPS, torch.from_numpy(valid))
    want = jax_masked_feature_sums([jnp.asarray(f) for f in feats], STEPS, jnp.asarray(valid))
    for g, w in zip(got, want):
        assert g.shape == (sum(STAGES) * STEPS,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-3)
    assert float(got[2][0]) == 2 * 16 * 16  # the padding row is not counted
    for g, w in zip(feature_moments([nchw(f) for f in feats], STEPS),
                    jax_feature_moments([jnp.asarray(f) for f in feats], STEPS)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_pddm_step_matches_jax(tmp_path):
    kw = dict(SMALL, standardize_features=True, saved_diffusion_model=str(tmp_path / "none"),
              log_dir=str(tmp_path / "run"))
    jcfg = JaxConfig(**kw).apply_experiment_preset()
    jloaders = jax_build_dataloaders("JSRT", None, SIZE, 2, 1, 3, seed=0, synthetic=True)
    jtask = jax_build_task(jcfg, jax.random.PRNGKey(0), jloaders)
    sds = task_state_dicts("PDDM", jax.tree_util.tree_map(np.asarray, jtask.params),
                           jax.tree_util.tree_map(np.asarray, jtask.batch_stats))
    assert np.abs(sds["classifier"]["mean"]).max() > 1e-3  # the pre-pass filled the statistics
    ds = SyntheticCXRDataset("train", 2, SIZE, labelled=True, seed=0)
    x, y = (np.stack(a) for a in zip(*(ds[i] for i in range(2))))
    valid = np.array([1, 0], np.float32)
    rng = jax.random.PRNGKey(5)
    tx = optax.adam(jcfg.lr)
    params_j, _, _, loss_j, _ = jax_make_train_step(jtask, tx)(
        jtask.params, jtask.batch_stats, tx.init(jtask.params), x, y, valid, rng, jnp.int32(1))
    noise = jax.random.normal(rng, (STEPS * 2, SIZE, SIZE, 1))  # as the JAX task draws the feature noise

    cfg = Config(**kw).apply_experiment_preset()
    task = per_step.build_task(cfg, device="cpu", compute_stats=False)
    for name, module in task.modules.items():
        load_numpy_state_dict(module, sds[name])
    probe = task.classifier
    assert task.trained is probe and task.fold == 1 and probe.standardize
    step = make_train_step(task, make_optimizer(cfg, probe.parameters()))
    loss, _ = step(nchw(x), nchw(y), torch.from_numpy(valid), noise=nchw(noise))
    assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = task_state_dicts("PDDM", jax.tree_util.tree_map(np.asarray, params_j),
                            jax.tree_util.tree_map(np.asarray, jtask.batch_stats))["classifier"]
    for name, p in probe.named_parameters():
        g = np.abs(p.grad.numpy())
        atol = np.where((g > 1e-4 * g.max()) & (g > 1e-6), 1e-3 * cfg.lr, 2 * cfg.lr)
        assert (np.abs(p.detach().numpy() - want[name]) <= atol).all(), name
    for p in task.unet.parameters():  # the backbone is frozen
        assert p.grad is None


def test_standardisation_prepass_is_the_moments_of_its_features(tmp_path):
    cfg = Config(**SMALL, standardize_features=True, saved_diffusion_model=str(tmp_path / "none"),
                 log_dir=str(tmp_path / "run")).apply_experiment_preset()
    mk = lambda: build_dataloaders("JSRT", None, SIZE, 2, 1, 3, seed=0, synthetic=True)  # a padded 2nd batch
    task = per_step.build_task(cfg, device="cpu", loaders=mk())
    gen = torch.Generator().manual_seed(cfg.seed)  # replay the pre-pass's batches and noise
    rows = []
    with torch.no_grad():
        for batch in mk()["train"]:
            feats = extract_features(task.unet, task.sched, to_nchw(batch["image"], "cpu"), task.t_steps,
                                     generator=gen, normalize=True)
            nvalid = int(batch["valid"].sum())
            rows.append([f.reshape(STEPS, -1, *f.shape[1:])[:, :nvalid] for f in feats])
    feats = [torch.cat([r[i] for r in rows], dim=1).flatten(0, 1) for i in range(2)]
    mean, std = feature_moments(feats, STEPS)
    torch.testing.assert_close(task.classifier.mean, mean, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(task.classifier.std, std + 1e-6, rtol=1e-4, atol=1e-5)


def test_pddm_main_then_run_tests_and_predictor(tmp_path):
    logs = tmp_path / "logs"
    train_main(["--experiment", "PDDM", "--t_steps_to_save", "1", "--standardize_features",
                "--n_labelled_images", "3", "--synthetic_data", "--dim", "8", "--dim_mults", "1", "2",
                "--img_size", "16", "--batch_size", "4", "--num_workers", "1",
                "--saved_diffusion_model", str(tmp_path / "none"), "--max_steps", "2", "--val_freq", "2",
                "--log_freq", "1", "--log_dir", str(logs / "run")], device="cpu")
    exp_dir = logs / "PDDM" / "3" / "run"
    state, _ = load_checkpoint(str(exp_dir / "best"), verbose=False)
    assert set(state) == {"backbone", "classifier", "opt_state", "step"}
    assert set(state["classifier"]) == {"weight", "bias", "mean", "std"} and state["classifier"]["mean"].abs().max() > 0

    outputs = run_tests.evaluate_experiment(str(exp_dir), device="cpu")
    assert sorted(outputs) == sorted(["JSRT_val", "JSRT_test", "NIH", "Montgomery"])
    assert outputs["JSRT_val"]["y_hat"].shape == (25, 16, 16, 1)
    assert all(os.path.exists(exp_dir / f"{k}_predictions.npz") for k in outputs)

    pred = Predictor(logs_root=str(logs), device="cpu")
    mask = pred.predict(np.random.RandomState(0).rand(1, 16, 16, 1).astype(np.float32), "PDDM", 3)
    assert mask.shape == (16, 16) and set(np.unique(mask)) <= {0.0, 1.0}
    _, task = next(iter(pred._cache.values()))
    for k, v in task.classifier.state_dict().items():  # the checkpoint's statistics, not the init
        torch.testing.assert_close(v, state["classifier"][k], atol=0, rtol=0)
