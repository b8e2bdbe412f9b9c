"""One data-parallel training step of the port on 2 gloo ranks against the
JAX package's step on a 2-device mesh (``tedm_tpu.parallel.data_parallel_setup``
with ``mesh_shape=(2,)``), on the CPU.

The global batch is 4 images, 2 a rank: the rows of rank 0, then those of
rank 1, as JAX lays out the sharded batch; the valid rows are [1, 1 | 1, 0],
so the ranks hold unequal counts. Weights come from JAX's init through
``utils.convert``; t, noise and region centres are JAX's draws for the
global batch, the CL views numpy's, cut per rank. Cases, each under DDP and
under FSDP (``--fsdp_min_size 64``: most weights sharded, the small ones
replicated): the backbone (``img_only``; the UNets have one stage unless said) plain and
with ``--grad_accum 2`` (JAX splits the global batch into microbatches,
each rank its own rows: the same global masked mean, its gradients reduced
on the last microbatch only), the TEDM head on that UNet (BatchNorm over
the global folded batch, a padded row), ``global_cl`` (NT-Xent over the
global views) and ``local_cl`` (the region loss over the global patches,
BatchNorm in g2, only ``ups[:2]`` training; two stages, since its head
reads the second decoder stage). Tolerances are
those of ``test_torch_train_diffusion.py::test_adam_step_matches_jax``: the
loss to 1e-5 relative, the parameters to 1e-3 * lr where the gradient is
more than 1e-4 of its tensor's largest entry and more than 1e-6, else to
2 * lr; BatchNorm statistics to 1e-6 absolute and 1e-5 relative. Both ranks
end with the same loss and parameters, and each FSDP forward starts a new
weight-layout epoch. Controls, each with one fix taken out, must miss
JAX's step: per-rank BatchNorm, an unweighted DDP mean of the ranks'
masked means, a per-rank NT-Xent.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as W
from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.models import contrastive as jc
from tedm_tpu.ops.schedules import make_schedule as jax_make_schedule
from tedm_tpu.parallel import data_parallel_setup
from tedm_tpu.trainers import diffusion as JD
from tedm_tpu.trainers.common import make_train_step as jax_make_train_step
from tedm_tpu.trainers.datasetdm import build_task as jax_build_task
from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
from tedm_tpu_torch.utils.convert import (
    classifier_state_dict,
    global_cl_state_dict,
    local_cl_state_dict,
    unet_state_dict,
)

SMALL = dict(dim=W.DIM, dim_mults=W.ONE_STAGE, img_size=W.SIZE, batch_size=4, lr=W.LR)
VALID = np.array([1, 1, 1, 0], np.float32)
CASES = ["img_only", "img_only accum 2", "TEDM", "global_cl", "local_cl"]


def nchw(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def as_numpy(tree):
    return jax.tree_util.tree_map(np.array, tree)


def mesh2(batch):
    """JAX's 2-device data-parallel wiring for a global batch of ``batch``."""
    return data_parallel_setup(JaxConfig(mesh_shape=(2,)), batch)


def jax_img_only(accum):
    jcfg = JaxConfig(**SMALL, experiment="img_only", grad_accum=accum)
    junet = JD.build_model(jcfg)
    params = as_numpy(JD.init_params(jcfg, junet, jax.random.PRNGKey(0)))
    ds = SyntheticCXRDataset("cxr_train", 16, W.SIZE, labelled=False, seed=0)
    x = np.stack([ds[i] for i in range(4)])
    rng = jax.random.PRNGKey(7)
    keys = [rng] if accum == 1 else [jax.random.fold_in(rng, i) for i in range(accum)]
    ts, noises = [], []
    for key, rows in zip(keys, np.split(x, len(keys))):  # train_loss's draws, microbatch by microbatch
        t_rng, noise_rng = jax.random.split(key)
        ts.append(np.asarray(jax.random.randint(t_rng, (rows.shape[0],), 0, 1000)))
        noises.append(np.asarray(jax.random.normal(noise_rng, rows.shape, jnp.float32)))
    tx = optax.adam(W.LR)
    shard, replicate = mesh2(4)
    train_step = JD.make_steps(jcfg, junet, jax_make_schedule(jcfg.timesteps, jcfg.beta_schedule), tx)[0]
    b = shard({"x": x, "valid": VALID})
    new, _, loss, _ = train_step(replicate(params), replicate(tx.init(params)), b["x"], jnp.zeros((1,)),
                                 b["valid"], rng)
    inputs = {"params": unet_state_dict(params), "x": nchw(x), "valid": VALID,
              "t": np.concatenate(ts).astype(np.int64), "noise": nchw(np.concatenate(noises))}
    return inputs, {"loss": float(loss), "params": unet_state_dict(as_numpy(new))}


def jax_tedm(tmp):
    jcfg = JaxConfig(**SMALL, experiment="TEDM", n_labelled_images=1,
                     saved_diffusion_model=os.path.join(tmp, "none")).apply_experiment_preset()
    jtask = jax_build_task(jcfg, jax.random.PRNGKey(0))
    params0, stats0 = as_numpy(jtask.params), as_numpy(jtask.batch_stats)
    ds = SyntheticCXRDataset("train", 4, W.SIZE, labelled=True, seed=0)
    x, y = (np.stack(a) for a in zip(*(ds[i] for i in range(4))))
    rng = jax.random.PRNGKey(5)
    s = len(jcfg.t_steps_to_save)
    noise = jax.random.normal(rng, (s * 4, W.SIZE, W.SIZE, 1))  # the task's feature noise, step-major
    tx = optax.adam(W.LR)
    shard, replicate = mesh2(4)
    b = shard({"x": x, "y": y, "valid": VALID})
    params_j, stats_j, _, loss, per_fold = jax_make_train_step(jtask, tx)(
        replicate(jtask.params), replicate(jtask.batch_stats), replicate(tx.init(jtask.params)),
        b["x"], b["y"], b["valid"], rng, jnp.int32(1))
    inputs = {"backbone": unet_state_dict(stats0["backbone"]),
              "classifier": classifier_state_dict(params0, stats0["bn"], shared=True),
              "x": nchw(x), "y": nchw(y), "valid": VALID, "noise": nchw(noise),
              "t_steps": list(jcfg.t_steps_to_save)}
    want = {"loss": float(loss), "per_fold": np.asarray(per_fold),
            "params": classifier_state_dict(as_numpy(params_j), as_numpy(stats_j)["bn"], shared=True)}
    return inputs, want


def jax_cl(local):
    mults, size = W.CL_SHAPES["local_cl" if local else "global_cl"]
    model = (jc.LocalCL if local else jc.GlobalCL)(img_size=size, dim=W.DIM, dim_mults=mults)
    zeros = jnp.zeros((2, size, size, 1))
    init = jax.jit(lambda key: model.init(key, zeros, **({"train": False} if local else {})))
    variables = as_numpy(init(jax.random.PRNGKey(2 if local else 1)))
    ds = SyntheticCXRDataset("cxr_train", 4, size, labelled=False, seed=0)
    x = np.stack([ds[i] for i in range(4)])
    rs = np.random.RandomState(3)  # two views of each image: brightness and contrast drawn with numpy
    views = np.concatenate([(x + rs.uniform(-0.3, 0.3, (4, 1, 1, 1))) * rs.uniform(0.7, 1.3, (4, 1, 1, 1))
                            for _ in range(2)]).astype(np.float32)
    key = jax.random.PRNGKey(9)
    kx, ky = jax.random.split(key)  # the centres local_region_loss draws from its key
    centres = [np.asarray(jax.random.permutation(k, size - 2)[:20] + 1).astype(np.int64) for k in (kx, ky)]
    tx = optax.adam(W.LR)
    shard, replicate = mesh2(8)
    p, bs = variables["params"], variables.get("batch_stats", {})

    def loss_fn(p, v):
        if not local:
            return jc.global_nt_xent(model.apply({"params": p}, v), 4, W.TAU), bs
        feats, upd = model.apply({"params": p, "batch_stats": bs}, v, train=True, mutable=["batch_stats"])
        return jc.local_region_loss(key, feats, 4, W.TAU), upd["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(replicate(p), shard({"v": views})["v"])
    if local:  # main_local's gradient mask: ups[:2] of the UNet alone
        keep = lambda path: path[0].key == "unet" and any(path[1].key.startswith(f"ups_{i}_") for i in range(2))
        grads = jax.tree_util.tree_map_with_path(lambda path, g: g * (1.0 if keep(path) else 0.0), grads)
    updates, _ = tx.update(grads, tx.init(p), p)
    new = as_numpy(optax.apply_updates(p, updates))
    convert = (lambda pp, ss: local_cl_state_dict(pp, ss)) if local else (lambda pp, ss: global_cl_state_dict(pp))
    inputs = {"params": convert(p, bs), "views": nchw(views), "centres": centres}
    return inputs, {"loss": float(loss), "params": convert(new, as_numpy(new_bs))}


JAX_STEPS = {"img_only": lambda tmp: jax_img_only(1), "img_only accum 2": lambda tmp: jax_img_only(2),
             "TEDM": jax_tedm, "global_cl": lambda tmp: jax_cl(False), "local_cl": lambda tmp: jax_cl(True)}


def run_cases(tmp_path_factory, cases):
    """JAX's steps of ``cases`` here, then the port's 2 ranks in one spawn."""
    tmp = str(tmp_path_factory.mktemp("parallel_steps"))
    inputs, want = {}, {}
    for name in cases:
        inputs[name], want[name] = JAX_STEPS[name](tmp)
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    W.spawn(W.step_cases, 2, tmp, path, tmp, timeout=300)
    return want, [torch.load(os.path.join(tmp, f"steps{r}.pt"), weights_only=False) for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory, CASES)


def deviations(got, want):
    """The names of what lies outside the tolerances (module docstring)."""
    bad = []
    if abs(got["loss"] - want["loss"]) > 1e-5 * abs(want["loss"]):
        bad.append(f"loss {got['loss']} vs {want['loss']}")
    for name, w in want["params"].items():
        if name.endswith("num_batches_tracked"):
            continue
        g = got["params"][name]
        if name.endswith(("running_mean", "running_var")):
            if not np.allclose(g, w, rtol=1e-5, atol=1e-6):
                bad.append(name)
            continue
        if name not in got["grads"]:  # frozen (local_cl): as it was, on both sides
            if not np.array_equal(g, w):
                bad.append(name)
            continue
        grad = np.abs(got["grads"][name])
        atol = np.where((grad > 1e-4 * grad.max()) & (grad > 1e-6), 1e-3 * W.LR, 2 * W.LR)
        if not (np.abs(g - w) <= atol).all():
            bad.append(name)
    return bad


@pytest.mark.parametrize("mode", ["replicated", "fsdp"], ids=["DDP", "FSDP"])
@pytest.mark.parametrize("case", CASES)
def test_step_matches_jax_2_device_mesh(runs, case, mode):
    want, got = runs
    r0, r1 = (g[case, mode] for g in got)
    assert deviations(r0, want[case]) == []
    assert r0["loss"] == r1["loss"]  # the global loss, on every rank
    for name, v in r0["params"].items():
        np.testing.assert_array_equal(r1["params"][name], v, err_msg=name)
    if case == "TEDM":
        np.testing.assert_allclose(r0["per_fold"], want[case]["per_fold"], rtol=1e-5, atol=0)
    if mode == "fsdp":  # each FSDP forward starts a new layout epoch (kernels/layouts.py)
        assert got[0]["layout epochs", mode] > 0



@pytest.mark.parametrize("case,control", [("TEDM", "per-rank BatchNorm"), ("TEDM", "unweighted DDP mean"),
                                          ("global_cl", "per-rank NT-Xent")])
def test_controls_miss_jax(runs, case, control):
    want, got = runs
    assert deviations(got[0][case, control], want[case]) != []
