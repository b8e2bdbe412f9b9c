"""The port's eval harness against ``tedm_tpu/eval/harness.py``, on the CPU.

For the baseline, a TEDM head and a PDDM probe (UNet dim 16, mults (1, 2),
32x32, batch 4), the JAX task's weights (perturbed, so that the predictions
spread) are written as a port checkpoint through ``utils.convert`` and
restored by ``load_experiment``. Both harnesses predict JSRT_val (25 images,
the last batch padded) with the feature noise JAX draws, read from its own
``fwd=`` hook and fed to the port's ``predict_dataset``: the npz files have
the same keys and shapes, y_hat agrees to 2e-4, the metrics of the same
y_hat are equal, and ``print_metrics`` prints the same text. Also: the test
loaders against JAX's, ``testing_shared_weights`` after ``train.main`` for
TEDM (one file a timestep and set, ``{}`` once done), the conditional
experiment's eval by its sampling chain (no longer refused), and a tiny
run of ``scripts/port/quality_r5.py`` on the CPU.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.eval import harness as jh
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.eval import harness, run_tests, testing_shared_weights
from tedm_tpu_torch.train import main as train_main
from tedm_tpu_torch.utils.checkpoint import save_checkpoint
from tedm_tpu_torch.utils.convert import task_state_dicts

torch.set_num_threads(1)

SMALL = dict(dim=16, dim_mults=(1, 2), img_size=32, batch_size=4, num_workers=1, synthetic_data=True,
             n_labelled_images=1)


def _experiment(tmp_path, experiment, **extra):
    """A JAX task with perturbed weights, and the same weights as a port
    experiment directory: (JAX config, JAX task, its state, the port's dir)."""
    kw = dict(SMALL, experiment=experiment, saved_diffusion_model=str(tmp_path / "none"),
              log_dir=str(tmp_path / "run"), **extra)
    jcfg = JaxConfig(**kw).apply_experiment_preset()
    jtask = jh.build_eval_task(jcfg)
    rs = np.random.RandomState(0)
    perturb = lambda tree: jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.1 * rs.randn(*np.shape(p)).astype(np.float32), tree)
    params = perturb(jtask.params)
    bstats = jax.tree_util.tree_map(np.asarray, jtask.batch_stats)
    if "backbone" in bstats:
        bstats["backbone"] = perturb(bstats["backbone"])
    if experiment == "PDDM":  # standardisation statistics of a plausible scale
        c = bstats["stats"]["mean"].shape[0]
        bstats["stats"] = {"mean": 0.1 * rs.randn(c).astype(np.float32), "std": (0.5 + rs.rand(c)).astype(np.float32)}
    cfg = Config(**kw).apply_experiment_preset()
    as_tensors = lambda sd: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    state = {k: as_tensors(v) for k, v in task_state_dicts(cfg.experiment, params, bstats).items()}
    save_checkpoint(os.path.join(cfg.log_dir, "best"), state, cfg)
    return jcfg, jtask, {"params": params, "batch_stats": bstats}, cfg.log_dir


@pytest.mark.parametrize("experiment,extra", [
    ("baseline", {}),
    ("TEDM", {}),
    ("PDDM", {"t_steps_to_save": (1, 200), "standardize_features": True}),
])
def test_harness_matches_jax(tmp_path, capsys, experiment, extra):
    jcfg, jtask, jstate, exp_dir = _experiment(tmp_path, experiment, **extra)
    jloader = jh.build_jsrt_loaders(jcfg)["val"]
    rngs = []
    jfwd = jh.make_predict_fn(jtask)

    def hook(params, bs, x, r):  # JAX's own fwd= hook: record each batch's key
        rngs.append(r)
        return jfwd(params, bs, x, r)

    jy_hat, jy_star = jh.predict_dataset(jtask, jstate, jloader, jax.random.PRNGKey(7), fold=jtask.fold, fwd=hook)
    steps = len(jcfg.t_steps_to_save) if experiment != "baseline" else 0
    # the noise the JAX task draws from each key (tedm_tpu/models/segmentation.py extract_features)
    noise = [np.asarray(jax.random.normal(r, (steps * 4, 32, 32, 1))) for r in rngs] if steps else None

    config, task = harness.load_experiment(exp_dir, device="cpu")
    assert config.experiment == experiment and task.fold == jtask.fold
    loader = harness.build_jsrt_loaders(config)["val"]
    y_hat, y_star = harness.predict_dataset(task, loader, fold=task.fold, noise=noise)
    assert y_hat.shape == jy_hat.shape and y_hat.shape[-4:] == (25, 32, 32, 1)
    np.testing.assert_array_equal(y_star, jy_star)
    assert 0.05 < float(jy_hat.std())  # probabilities not saturated: the comparison has teeth
    np.testing.assert_allclose(y_hat, jy_hat, atol=2e-4, rtol=0)

    ens = (lambda a: a.mean(axis=0)) if task.fold > 1 else (lambda a: a)
    ours, theirs = harness.compute_output(ens(jy_hat), jy_star), jh.compute_output(ens(jy_hat), jy_star)
    harness.save_output(str(tmp_path / "port.npz"), ours)
    jh.save_output(str(tmp_path / "jax.npz"), theirs)
    a, b = harness.load_output(str(tmp_path / "port.npz")), jh.load_output(str(tmp_path / "jax.npz"))
    assert sorted(a) == sorted(b) == ["dice", "precision", "recall", "y_hat", "y_star"]
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])
    capsys.readouterr()
    harness.print_metrics("JSRT_val", a)
    text = capsys.readouterr().out
    jh.print_metrics("JSRT_val", b)
    assert text == capsys.readouterr().out and "dice:" in text


def test_test_loaders_match_jax(tmp_path):
    kw = dict(SMALL, experiment="TEDM", log_dir=str(tmp_path / "run"))
    ours = harness.build_test_loaders(Config(**kw).apply_experiment_preset())
    theirs = jh.build_test_loaders(JaxConfig(**kw).apply_experiment_preset())
    assert list(ours) == list(theirs) == list(harness.DATASET_KEYS)
    for key in ours:
        assert len(ours[key].indices) == len(theirs[key].indices) == (25 if key.startswith("JSRT") else 100)
        a, b = next(iter(ours[key])), next(iter(theirs[key]))
        for k in ("image", "mask", "valid"):
            np.testing.assert_array_equal(a[k], b[k])


def test_tedm_main_then_testing_shared_weights(tmp_path, capsys):
    logs = tmp_path / "logs"
    train_main(["--experiment", "TEDM", "--n_labelled_images", "1", "--synthetic_data", "--dim", "8",
                "--dim_mults", "1", "2", "--img_size", "16", "--batch_size", "4", "--num_workers", "1",
                "--saved_diffusion_model", str(tmp_path / "none"), "--max_steps", "2", "--val_freq", "2",
                "--log_freq", "1", "--log_dir", str(logs / "run")], device="cpu")
    exp_dir = str(logs / "TEDM" / "1" / "run")
    testing_shared_weights.main(["--experiment", exp_dir], device="cpu")
    files = set(os.listdir(exp_dir))
    t_steps = (1, 10, 25, 50, 200, 400, 600, 800)
    for key in harness.DATASET_KEYS:
        assert f"{key}_predictions.npz" in files
        assert {f"{key}_timestep{t}_predictions.npz" for t in t_steps} <= files
    ens = harness.load_output(os.path.join(exp_dir, "NIH_predictions.npz"))
    per_t = [harness.load_output(os.path.join(exp_dir, f"NIH_timestep{t}_predictions.npz"))["y_hat"] for t in t_steps]
    np.testing.assert_allclose(ens["y_hat"], np.mean(per_t, axis=0), rtol=1e-6, atol=1e-7)
    assert testing_shared_weights.evaluate_shared_weights(exp_dir, device="cpu") == {}
    # run_tests on the same head ensembles the timesteps too, with its own noise stream
    out = run_tests.evaluate_experiment(exp_dir, rerun=True, device="cpu")
    assert out["JSRT_test"]["y_hat"].shape == (25, 16, 16, 1)


def test_conditional_eval_names_its_roadmap_item(tmp_path):
    """The conditional experiment was refused as ROADMAP A.5e; it is now
    evaluated by DDIM under its config's ``ddim_steps``, one npz a set."""
    from tedm_tpu_torch.trainers.diffusion import build_model

    cfg = Config(**dict(SMALL, dim=8, img_size=16), experiment="conditional", timesteps=20, ddim_steps=2,
                 log_dir=str(tmp_path / "run"))
    save_checkpoint(str(tmp_path / "run" / "best"), {"params": build_model(cfg).state_dict()}, cfg)
    out = run_tests.evaluate_experiment(str(tmp_path / "run"), device="cpu")
    assert sorted(out) == sorted(harness.DATASET_KEYS)
    assert out["NIH"]["y_hat"].shape == (100, 16, 16, 1)


def test_quality_r5_runs_its_chain_on_the_cpu(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts", "port"))
    import quality_r5

    out = tmp_path / "runs"
    quality_r5.main(["--root", str(tmp_path / "corpus"), "--out", str(out), "--img_size", "16", "--n_cxr", "4",
                     "--backbone_steps", "1", "--head_steps", "1", "--sizes", "1", "--seeds", "0",
                     "--device", "cpu", "--extra", "--dim", "8", "--dim_mults", "1", "2", "--timesteps", "20"])
    with open(out / "s0" / "summary.json") as f:
        summary = json.load(f)
    assert summary["framework"] == "tedm_tpu_torch" and summary["img_size"] == 16
    assert sorted(summary["experiments"]) == ["Step_1/1", "TEDM/1", "baseline/1"]
    for cell in summary["experiments"].values():  # run_tpu.py's schema
        assert {"JSRT_val", "JSRT_test", "NIH", "Montgomery", "mechanism"} <= set(cell)
        assert cell["JSRT_test"]["n"] == 25 and cell["NIH"]["n"] == 100
        assert set(cell["NIH"]) >= {"dice_mean", "dice_std", "precision_mean", "recall_mean"}
    assert len(summary["experiments"]["TEDM/1"]["NIH"]["per_timestep"]) == 8
    with open(out / "quality.json") as f:
        cells = json.load(f)["cells"]
    # the r5 bands of the JSRT_test cells, from docs/parity_artifacts/r5/seed_table.json
    assert [round(x, 2) for x in cells["TEDM/1|JSRT_test"]["band"]] == [78.83, 81.58]
    assert [round(x, 2) for x in cells["baseline/1|JSRT_test"]["band"]] == [74.54, 84.07]
    assert [round(x, 2) for x in cells["Step_1/1|JSRT_test"]["band"]] == [78.19, 81.19]
    assert "band" not in cells["TEDM/1|NIH"]
