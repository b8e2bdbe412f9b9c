"""One spatially sharded training step of the port on gloo ranks against the
JAX package's step under ``data_parallel_setup`` with
``Config(mesh_shape=..., mesh_axes=("data", "spatial"), shard_spatial=True)``
on CPU devices, the batch's H axis sharded over ``spatial``
(``torch_sp_worker.step_cases``).

The mesh is (1, 2): 2 ranks each holding 16 of the 32 rows of the whole
global batch of 4 (valid rows [1, 1, 1, 0]); ``test_torch_sp_mesh.py``
runs (2, 2). Cases: the
backbone (``img_only``, one Adam step), the TEDM head on a frozen backbone
(BatchNorm over the data x spatial ranks), the baseline (the whole UNet)
and PDDM's probe (its standardisation pre-pass under spatial sharding is
``test_torch_sp_cli.py``'s); every UNet has one stage (the halo file runs
two). Weights come from JAX's init through ``utils.convert``; t,
noise and feature noise are JAX's draws, whole, each rank taking its rows.
Against JAX: the loss to 2e-4 relative, the parameters after the Adam step
as ``test_torch_parallel_steps.deviations`` holds them (1e-3 * lr where the
gradient is significant, else 2 * lr), BatchNorm's running statistics to
1e-5 relative. The gradients against the port's one-process step on the
same inputs to 2e-4 of each tensor's largest entry (or of 0.1 of the
module's largest gradient entry where that is more: a conv bias before a
GroupNorm has a gradient of rounding alone). Every rank ends with the same
loss and parameters. Controls that must miss JAX's step: GroupNorm with
each rank's own statistics, BatchNorm reduced over the data group alone.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_parallel_steps as S
import torch_parallel_worker as W
import torch_sp_worker as SW
from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.parallel import data_parallel_setup
from tedm_tpu.trainers.baseline import build_task as jax_baseline_task
from tedm_tpu.trainers.common import make_train_step as jax_make_train_step
from tedm_tpu.trainers.per_step import build_task as jax_pddm_task
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.utils.convert import task_state_dicts, unet_state_dict

torch.set_num_threads(1)

CASES = ["img_only", "TEDM", "baseline", "PDDM"]
SMALL = dict(dim=W.DIM, dim_mults=W.ONE_STAGE, img_size=W.SIZE, batch_size=4, lr=W.LR)


def jax_sp_mesh(shape):
    """JAX's wiring of a (data, spatial) mesh of ``shape`` under --shard_spatial."""
    return lambda batch: data_parallel_setup(
        JaxConfig(mesh_shape=shape, mesh_axes=("data", "spatial"), shard_spatial=True), batch)


def labelled_batch():
    ds = SyntheticCXRDataset("train", 4, W.SIZE, labelled=True, seed=0)
    return (np.stack(a) for a in zip(*(ds[i] for i in range(4))))


def jax_segmentation_step(jtask, x, y, rng):
    tx = optax.adam(W.LR)
    shard, replicate = S.mesh2(4)
    b = shard({"x": x, "y": y, "valid": S.VALID})
    params, stats, _, loss, _ = jax_make_train_step(jtask, tx)(
        replicate(jtask.params), replicate(jtask.batch_stats), replicate(tx.init(jtask.params)),
        b["x"], b["y"], b["valid"], rng, jnp.int32(1))
    return S.as_numpy(params), S.as_numpy(stats), float(loss)


def jax_baseline(tmp):
    jcfg = JaxConfig(**SMALL, experiment="baseline", log_dir=os.path.join(tmp, "b")).apply_experiment_preset()
    jtask = jax_baseline_task(jcfg, jax.random.PRNGKey(0))
    params0 = S.as_numpy(jtask.params)
    x, y = labelled_batch()
    params, _, loss = jax_segmentation_step(jtask, x, y, jax.random.PRNGKey(5))
    inputs = {"params": unet_state_dict(params0), "x": S.nchw(x), "y": S.nchw(y), "valid": S.VALID}
    return inputs, {"loss": loss, "params": unet_state_dict(params)}


def jax_pddm(tmp):
    jcfg = JaxConfig(**SMALL, experiment="PDDM", n_labelled_images=3, t_steps_to_save=(1, 200),
                     saved_diffusion_model=os.path.join(tmp, "none"),
                     log_dir=os.path.join(tmp, "p")).apply_experiment_preset()
    jtask = jax_pddm_task(jcfg, jax.random.PRNGKey(0))
    sds = task_state_dicts("PDDM", S.as_numpy(jtask.params), S.as_numpy(jtask.batch_stats))
    x, y = labelled_batch()
    rng = jax.random.PRNGKey(5)
    noise = jax.random.normal(rng, (2 * 4, W.SIZE, W.SIZE, 1))  # the task's feature noise, step-major
    params, stats, loss = jax_segmentation_step(jtask, x, y, rng)
    inputs = {"backbone": sds["backbone"], "probe": sds["classifier"], "x": S.nchw(x), "y": S.nchw(y),
              "valid": S.VALID, "noise": S.nchw(noise), "t_steps": [1, 200]}
    return inputs, {"loss": loss, "params": task_state_dicts("PDDM", params, stats)["classifier"]}


JAX_STEPS = {"img_only": S.JAX_STEPS["img_only"], "TEDM": S.JAX_STEPS["TEDM"], "baseline": jax_baseline,
             "PDDM": jax_pddm}


def run_sp_cases(tmp_path_factory, shape, cases):
    """JAX's steps of ``cases`` on its ``shape`` mesh here, the port's one
    process on the same inputs, then the port's ranks in one spawn."""
    tmp = str(tmp_path_factory.mktemp("sp_steps"))
    inputs, want = {}, {}
    with W.patched(S, "mesh2", jax_sp_mesh(shape)):
        for name in cases:
            inputs[name], want[name] = JAX_STEPS[name](tmp)
    one = {name: SW.STEPS[name](inputs[name]) for name in cases}
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    world = shape[0] * shape[1]
    W.spawn(SW.step_cases, world, tmp, path, tmp, shape, timeout=300)
    return want, one, [torch.load(os.path.join(tmp, f"steps{r}.pt"), weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_sp_cases(tmp_path_factory, (1, 2), CASES)


def deviations(got, want):
    """What lies outside the tolerances against JAX (module docstring)."""
    bad = [] if abs(got["loss"] - want["loss"]) <= 2e-4 * abs(want["loss"]) else [f"loss {got['loss']} vs {want['loss']}"]
    return bad + [b for b in S.deviations({**got, "loss": want["loss"]}, want)]


def grad_deviations(got, want):
    floor = 0.1 * max(np.abs(g).max() for g in want.values())
    assert got.keys() == want.keys()
    return [n for n, g in want.items() if not np.abs(got[n] - g).max() <= 2e-4 * max(np.abs(g).max(), floor)]


def check(want, one, got, case):
    r0 = got[0][case]
    assert deviations(r0, want[case]) == []
    assert grad_deviations(r0["grads"], one[case]["grads"]) == []
    for other in got[1:]:
        assert other[case]["loss"] == r0["loss"]  # the global loss, on every rank
        for name, v in r0["params"].items():
            np.testing.assert_array_equal(other[case]["params"][name], v, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_sp_step_matches_jax_1x2_mesh(runs, case):
    check(*runs, case)


@pytest.mark.parametrize("case,control", [("img_only", "GroupNorm without spatial_sum"),
                                          ("TEDM", "BatchNorm over the data group")])
def test_sp_controls_miss_jax(runs, case, control):
    want, _, got = runs
    assert deviations(got[0][case, control], want[case]) != []
