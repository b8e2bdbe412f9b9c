"""The eval CLIs under ``--shard_spatial`` on 2 gloo ranks, mesh (1, 2) over
("data", "spatial"), against one process and against the JAX package
(``torch_sp_cl_worker.eval_cases``), on the CPU.

Three runs whose configs shard spatially (UNet dim 16, mults (1, 2), 32^2,
batch 4), from the port's seeded init: a TEDM head (timesteps 1 and 200),
a ``glob_loc_finetune`` UNet and a ``conditional`` backbone (DDIM, 2 steps,
5 trajectories a batch). ``testing_shared_weights`` (the head) and ``run_tests`` (the
finetune, the conditional chain) run with ``--multihost`` over the first 5
images of each test set: each rank predicts its 16 rows of every image, the
noise drawn whole and cut, the metrics add their counts over the two ranks,
and rank 0 writes the npz files, the images gathered along H. Every file
equals the one the same CLI writes in one process: y_star exactly, y_hat to
2e-4, per-image Dice, precision and recall to 1e-6. Against JAX: the
finetune's JSRT_val file, y_hat to 2e-4 of
``tedm_tpu.eval.harness.predict_dataset``'s on the same weights (through
``tedm_tpu.utils.torch_port``) and the metrics equal to JAX's
``compute_output`` of the file's y_hat; the TEDM head's path through the
harness is held against JAX by ``test_torch_eval_harness.py``.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_eval_harness as EH
import torch_parallel_worker as W
import torch_sp_cl_worker as CW
from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.eval import harness as jh
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.trainers.common import SegTask
from tedm_tpu.utils.torch_port import convert_unet_state_dict
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.eval import harness, run_tests, testing_shared_weights
from tedm_tpu_torch.trainers import baseline, datasetdm, diffusion
from tedm_tpu_torch.utils.checkpoint import save_checkpoint

torch.set_num_threads(1)

SP = dict(mesh_shape=(1, 2), mesh_axes=("data", "spatial"), shard_spatial=True)
RUNS = ("testing_shared_weights", "glob_loc_finetune", "conditional")
T_STEPS = (1, 200)  # the TEDM head's timesteps
DATASETS = ("JSRT_val", "JSRT_test", "NIH", "Montgomery")


def port_run(tmp, experiment):
    """A run directory of ``experiment`` with the port's seeded init (a
    head's backbone too)."""
    cfg = Config(**EH.SMALL, **SP, experiment=experiment, ddim_steps=2, timesteps=20,
                 saved_diffusion_model=os.path.join(tmp, "none"),
                 log_dir=os.path.join(tmp, experiment)).apply_experiment_preset().replace(t_steps_to_save=T_STEPS)
    if experiment == "conditional":
        state = {"params": diffusion.build_model(cfg).state_dict()}
    else:
        task = (datasetdm if experiment == "TEDM" else baseline).build_task(cfg, "cpu")
        state = {k: m.state_dict() for k, m in task.modules.items()}
    save_checkpoint(os.path.join(cfg.log_dir, "best"), state, cfg)
    return cfg.log_dir


def jax_val_predictions(exp_dir):
    """JAX's harness on the finetune's UNet: JSRT_val's first 5 images."""
    from tedm_tpu_torch.utils.checkpoint import load_checkpoint

    state, _ = load_checkpoint(os.path.join(exp_dir, "best"), map_location="cpu", verbose=False)
    params = convert_unet_state_dict({k: v.numpy() for k, v in state["unet"].items()}, n_stages=2)
    junet = JaxUnet(dim=16, dim_mults=(1, 2), channels=1)
    jtask = SegTask(apply=lambda p, aux, x, rng, train: (junet.apply({"params": p}, x, None).astype(jnp.float32), aux),
                    params=params, batch_stats={})
    jcfg = JaxConfig(**EH.SMALL, experiment="glob_loc_finetune")
    loader = W.small_sets(lambda c: {"val": jh.build_jsrt_loaders(c)["val"]})(jcfg)["val"]
    return jh.predict_dataset(jtask, {"params": params, "batch_stats": {}}, loader, jax.random.PRNGKey(0))


def npz_files(exp_dir):
    return sorted(f for f in os.listdir(exp_dir) if f.endswith("_predictions.npz"))


@pytest.fixture(scope="module")
def evals(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("sp_eval"))
    runs = {name: port_run(tmp, "TEDM" if name == "testing_shared_weights" else name) for name in RUNS}
    one = {name: os.path.join(tmp, "one", name) for name in runs}  # the same runs for one process
    for name, d in runs.items():
        shutil.copytree(d, one[name])
    W.spawn(CW.eval_cases, 2, tmp, runs, timeout=300)
    for name, d in one.items():
        cli = testing_shared_weights if name == "testing_shared_weights" else run_tests
        with W.patched(cli, "build_test_loaders", W.small_sets(cli.build_test_loaders)):
            cli.main(["-e", d, "--rerun"], device="cpu")
    return runs, one, jax_val_predictions(runs["glob_loc_finetune"])


@pytest.mark.parametrize("name", RUNS)
def test_sharded_eval_cli_writes_one_process_npz(evals, name):
    runs, one, _ = evals
    files = npz_files(runs[name])
    assert files == npz_files(one[name])
    assert {f"{k}_predictions.npz" for k in DATASETS} <= set(files)
    if name == "testing_shared_weights":  # and one file a timestep and set
        assert len(files) == 4 * (1 + len(T_STEPS))
    for f in files:
        a, b = harness.load_output(os.path.join(runs[name], f)), harness.load_output(os.path.join(one[name], f))
        assert a["y_hat"].shape == b["y_hat"].shape == (5, 32, 32, 1), f
        np.testing.assert_array_equal(a["y_star"], b["y_star"])
        np.testing.assert_allclose(a["y_hat"], b["y_hat"], atol=2e-4, rtol=0, err_msg=f)
        for k in ("dice", "precision", "recall"):
            np.testing.assert_allclose(a[k], b[k], atol=1e-6, rtol=0, err_msg=f"{f} {k}")


def test_sharded_finetune_eval_matches_jax(evals):
    runs, _, (jy_hat, jy_star) = evals
    got = harness.load_output(os.path.join(runs["glob_loc_finetune"], "JSRT_val_predictions.npz"))
    np.testing.assert_array_equal(got["y_star"], jy_star)
    assert 0.01 < float(jy_hat.std())  # probabilities that spread: the comparison has teeth
    np.testing.assert_allclose(got["y_hat"], jy_hat, atol=2e-4, rtol=0)
    want = jh.compute_output(got["y_hat"], got["y_star"])
    for k in ("dice", "precision", "recall"):
        np.testing.assert_array_equal(got[k], want[k])
