"""One spatially sharded step of the contrastive arms of the port on 2 gloo
ranks, mesh (1, 2) over ("data", "spatial"), against the JAX package's step
under ``data_parallel_setup`` with ``shard_spatial=True`` on the same mesh of
CPU devices (``torch_sp_cl_worker.step_cases``); ``test_torch_sp_cl_mesh.py``
runs LocalCL on a (2, 2) mesh.

Cases: ``global_cl`` (UNet of one stage at 16^2, its head flattening the
mid map), ``local_cl`` (mults (1, 2) at 32^2: the region loss over 3x3 boxes
of the decoder map, BatchNorm in g2, only ``ups[:2]`` training) and a
finetune step (the baseline UNet of one stage at 32^2 with
``FROZEN_PREFIXES`` frozen, as before ``--unfreeze_weights_at_step``). JAX
builds the CL views inside its step from the H-sharded batch (a crop of the
whole images, then brightness and contrast); the port builds them from the
whole images with JAX's draws and keeps each rank's rows. Weights come from
JAX's init through ``utils.convert`` (the finetune's from the port's init
through ``tedm_tpu.utils.torch_port``). Tolerances are
``test_torch_sp_steps.py``'s: against JAX the loss to 2e-4 relative, the
parameters after the Adam step as ``test_torch_parallel_steps.deviations``
holds them, BatchNorm's running statistics to 1e-5 relative; the gradients
against the port's one-process step to 2e-4 of each tensor's largest entry
(or 0.1 of the module's largest); every rank ends with the same loss and
parameters. Controls that must miss JAX's step: the views cropped from each
rank's own rows, and LocalCL's boxes cut from a rank's rows of the decoder
map without the gather.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_parallel_steps as S
import test_torch_sp_steps as SS
import torch_parallel_worker as W
import torch_sp_cl_worker as CW
from tedm_tpu.config import Config as JaxConfig
from tedm_tpu.models import contrastive as jc
from tedm_tpu.models.unet import Unet as JaxUnet
from tedm_tpu.ops import augment as ja
from tedm_tpu.parallel import data_parallel_setup
from tedm_tpu.trainers.common import SegTask, make_train_step as jax_make_train_step
from tedm_tpu.trainers.contrastive import FROZEN_PREFIXES, _grad_mask
from tedm_tpu.utils.torch_port import convert_unet_state_dict
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.utils.convert import global_cl_state_dict, local_cl_state_dict, unet_state_dict

torch.set_num_threads(1)

CASES = ["global_cl", "local_cl", "finetune"]


def jax_draws(key, size):
    """The crop, brightness and contrast draws of JAX's ``augment_and_concat``
    (tedm_tpu/ops/augment.py) from ``key`` for a batch of 4, per view, as the
    port's arguments (numpy)."""
    out = []
    for kv in jax.random.split(key):
        ka, kb = jax.random.split(kv)
        k1, k2, k3, k4 = jax.random.split(ka, 4)
        ox, oy = (np.asarray(jax.random.randint(k, (4,), 0, 32)).astype(np.float32) for k in (k1, k2))
        ux, uy = (np.asarray(jax.random.uniform(k, (4,))) for k in (k3, k4))
        origin = np.stack([ox, oy], 1)
        box = np.stack([96 + ux * (size - ox - 96), 96 + uy * (size - oy - 96)], 1).astype(np.float32)
        kb1, kb2 = jax.random.split(kb)
        brightness = np.asarray(jax.random.uniform(kb1, (4, 1, 1, 1))) * 0.6 - 0.3
        contrast = np.asarray(jax.random.uniform(kb2, (4, 1, 1, 1))) * 0.6 + 0.7
        out.append((origin, box, brightness, contrast))
    return out


def jax_mesh(shape, axes):
    """JAX's wiring of a mesh of ``shape`` over ``axes``, spatially sharded
    when it has a ``spatial`` axis."""
    return lambda batch: data_parallel_setup(
        JaxConfig(mesh_shape=shape, mesh_axes=axes, shard_spatial="spatial" in axes), batch)


def jax_cl(experiment, shape, axes=("data", "spatial")):
    """JAX's CL step as ``_train_cl``'s ``loss_fn`` runs it, on its
    ``shape`` mesh: the views from the sharded batch, then the loss."""
    local = experiment == "local_cl"
    mults, size = CW.CL_SHAPES[experiment]
    model = (jc.LocalCL if local else jc.GlobalCL)(img_size=size, dim=W.DIM, dim_mults=mults)
    init = jax.jit(lambda key: model.init(key, jnp.zeros((2, size, size, 1)), **({"train": False} if local else {})))
    variables = S.as_numpy(init(jax.random.PRNGKey(2 if local else 1)))
    ds = SS.SyntheticCXRDataset("cxr_train", 4, size, labelled=False, seed=0)
    x = np.stack([ds[i] for i in range(4)])
    k_aug, k_loss = jax.random.split(jax.random.PRNGKey(9))
    kx, ky = jax.random.split(k_loss)  # the centres local_region_loss draws from its key
    centres = [np.asarray(jax.random.permutation(k, size - 2)[:20] + 1).astype(np.int64) for k in (kx, ky)]
    tx = optax.adam(W.LR)
    shard, replicate = jax_mesh(shape, axes)(4)
    p, bs = variables["params"], variables.get("batch_stats", {})

    def loss_fn(p, x):
        views = ja.augment_and_concat(k_aug, x)
        if not local:
            return jc.global_nt_xent(model.apply({"params": p}, views), 4, W.TAU), bs
        feats, upd = model.apply({"params": p, "batch_stats": bs}, views, train=True, mutable=["batch_stats"])
        return jc.local_region_loss(k_loss, feats, 4, W.TAU), upd["batch_stats"]

    (loss, new_bs), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(replicate(p), shard({"x": x})["x"])
    if local:  # main_local's gradient mask: ups[:2] of the UNet alone
        keep = lambda path: path[0].key == "unet" and any(path[1].key.startswith(f"ups_{i}_") for i in range(2))
        grads = jax.tree_util.tree_map_with_path(lambda path, g: g * (1.0 if keep(path) else 0.0), grads)
    updates, _ = tx.update(grads, tx.init(p), p)
    new = S.as_numpy(optax.apply_updates(p, updates))
    convert = (lambda pp, ss: local_cl_state_dict(pp, ss)) if local else (lambda pp, ss: global_cl_state_dict(pp))
    inputs = {"params": convert(p, bs), "x": S.nchw(x), "centres": centres, "draws": jax_draws(k_aug, size)}
    return inputs, {"loss": float(loss), "params": convert(new, S.as_numpy(new_bs))}


def jax_finetune(shape):
    """JAX's finetune step (the shared supervised step with the freeze mask
    of ``main_finetune``, before its unfreeze step) on its ``shape`` mesh,
    from the port's init of a one-stage UNet."""
    torch.manual_seed(0)
    sd = {k: v.numpy() for k, v in Unet(dim=W.DIM, dim_mults=W.ONE_STAGE).state_dict().items()}
    params = convert_unet_state_dict(sd, n_stages=1)
    junet = JaxUnet(dim=W.DIM, dim_mults=W.ONE_STAGE, channels=1)
    task = SegTask(apply=lambda p, aux, x, rng, train: (junet.apply({"params": p}, x, None).astype(jnp.float32), aux),
                   params=params, batch_stats={})
    x, y = SS.labelled_batch()
    tx = optax.adam(W.LR)
    mask = _grad_mask(params, lambda k: not k.startswith(FROZEN_PREFIXES))
    shard, replicate = SS.jax_sp_mesh(shape)(4)
    b = shard({"x": x, "y": y, "valid": S.VALID})
    new, _, _, loss, _ = jax_make_train_step(task, tx, freeze_mask=replicate(mask), unfreeze_at=2)(
        replicate(params), {}, replicate(tx.init(params)), b["x"], b["y"], b["valid"], jax.random.PRNGKey(5),
        jnp.int32(1))
    inputs = {"params": sd, "x": S.nchw(x), "y": S.nchw(y), "valid": S.VALID}
    return inputs, {"loss": float(loss), "params": unet_state_dict(S.as_numpy(new))}


def run_cl_cases(tmp_path_factory, shape, cases, axes=("data", "spatial")):
    """JAX's steps of ``cases`` on its ``shape`` mesh over ``axes`` here, the
    port's one process on the same inputs, then the port's ranks in one
    spawn."""
    tmp = str(tmp_path_factory.mktemp("sp_cl"))
    inputs, want = {}, {}
    for name in cases:
        inputs[name], want[name] = jax_finetune(shape) if name == "finetune" else jax_cl(name, shape, axes)
    one = {name: CW.STEPS[name](inputs[name]) for name in cases}
    path = os.path.join(tmp, "inputs.pt")
    torch.save(inputs, path)
    world = shape[0] * shape[1]
    W.spawn(CW.step_cases, world, tmp, path, tmp, shape, axes, timeout=300)
    return want, one, [torch.load(os.path.join(tmp, f"steps{r}.pt"), weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cl_cases(tmp_path_factory, (1, 2), CASES)


@pytest.mark.parametrize("case", CASES)
def test_sp_cl_step_matches_jax_1x2_mesh(runs, case):
    SS.check(*runs, case)


@pytest.mark.parametrize("case,control", [("global_cl", "views cropped from local rows"),
                                          ("local_cl", "views cropped from local rows"),
                                          ("local_cl", "boxes from local rows")])
def test_sp_cl_controls_miss_jax(runs, case, control):
    want, _, got = runs
    assert SS.deviations(got[0][case, control], want[case]) != []
