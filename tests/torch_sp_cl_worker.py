"""The ranks of the port's spatial-parallel tests of the contrastive arms and
of the eval CLIs (``tests/test_torch_sp_cl*.py``, ``tests/test_torch_sp_eval.py``),
and of the replica axis (``tests/test_torch_mesh_axes.py``).

Each function runs in every rank that ``torch_parallel_worker.spawn``
starts (or, for the one-process reference, in the test's own process),
builds its mesh (``("data", "spatial")``, or any axes given) and imports
only the port. Data rank d takes rows ``d * 4 / D`` on of the global batch
of 4, whole: the trainers keep each rank's rows of H.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from torch_parallel_worker import DIM, LR, ONE_STAGE, TAU, _numpy, patched
from torch_sp_worker import _grads, _rows

# (dim_mults, img_size): GlobalCL's head flattens a one-stage UNet's mid at
# 16^2; LocalCL's reads the second decoder stage, at 32^2 (30 rows for the
# region centres)
CL_SHAPES = {"global_cl": (ONE_STAGE, 16), "local_cl": ((1, 2), 32)}


def _dp():
    from tedm_tpu_torch.parallel import mesh

    return mesh.DataParallel("replicated", shard_spatial=True)


def views_of(draws, x: torch.Tensor) -> torch.Tensor:
    """The two views of ``x``, this data rank's rows of the global batch,
    with JAX's draws of those rows (a crop, then brightness and contrast)."""
    from tedm_tpu_torch.ops.augment import brightness_contrast, crop_batch

    rows = lambda a: _rows(a)
    return torch.cat([brightness_contrast(crop_batch(x, origin=rows(o), box=rows(b)), brightness=rows(br),
                                          contrast=rows(c)) for o, b, br, c in draws])


def local_crops(draws):
    """The control's augment: each rank crops its own rows as if they were
    whole images, and the views hold those crops at its rows."""
    from tedm_tpu_torch.parallel import mesh, spatial

    def augment(x, generator):
        with spatial.sharded(mesh.spatial_plan()):
            return spatial.gather_h(views_of(draws, spatial.local_rows(x)))

    return augment


def local_boxes(region_rows):
    """The control's region crop: boxes cut from this rank's rows of the
    decoder map (not gathered), the row centres clamped into them."""

    def cut(features, batch_size, centres, n_regions=20):
        cx, cy = centres
        return region_rows(features, batch_size, (cx.clamp(1, features.shape[2] - 2), cy), n_regions)

    return cut


def cl_step(d, experiment: str, augment=None) -> Dict[str, Any]:
    """One GlobalCL or LocalCL step of ``train_step`` on this data rank's
    images, the views built by ``augment`` (``views_of`` by default) in
    place of the generator's."""
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.models import contrastive as tc
    from tedm_tpu_torch.trainers import contrastive
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    mults, size = CL_SHAPES[experiment]
    cfg = Config(experiment=experiment, dim=DIM, dim_mults=mults, img_size=size, batch_size=2, lr=LR,
                 tau=TAU).apply_experiment_preset()
    cls = tc.LocalCL if experiment == "local_cl" else tc.GlobalCL
    model = load_numpy_state_dict(cls(img_size=size, dim=DIM, dim_mults=mults), d["params"])
    contrastive.trainable_parameters(model)
    dp = _dp()
    forward = dp.wrap(model)
    optimizer = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=LR, foreach=True)
    steps = contrastive.make_steps(cfg, model, optimizer, forward, dp)
    centres = tuple(torch.from_numpy(c) for c in d["centres"]) if experiment == "local_cl" else None
    augment = augment or (lambda x, generator: views_of(d["draws"], x))
    with patched(contrastive, "augment_and_concat", augment):
        loss = steps.train_step(_rows(d["x"]), centres=centres)
    return {"loss": float(loss), "params": _numpy(dp.state_dict(model)), "grads": _grads(model)}


def finetune_step(d) -> Dict[str, Any]:
    """One finetune step (the baseline UNet, ``FROZEN_PREFIXES`` frozen)."""
    from tedm_tpu_torch.models.unet import Unet
    from tedm_tpu_torch.trainers.baseline import BaselineTask
    from tedm_tpu_torch.trainers.common import make_train_step
    from tedm_tpu_torch.trainers.contrastive import FROZEN_PREFIXES
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    unet = load_numpy_state_dict(Unet(dim=DIM, dim_mults=ONE_STAGE), d["params"])
    frozen = [p for n, p in unet.named_parameters() if n.startswith(FROZEN_PREFIXES)]
    dp = _dp()
    task = BaselineTask(unet=dp.wrap(unet, find_unused=True))
    step = make_train_step(task, torch.optim.Adam(unet.parameters(), lr=LR, foreach=True), frozen, dp)
    loss, _ = step(_rows(d["x"]), _rows(d["y"]), _rows(d["valid"]), freeze=True)
    grads = {n: g for n, g in _grads(unet).items() if not n.startswith(FROZEN_PREFIXES)}
    return {"loss": float(loss), "params": _numpy(dp.state_dict(unet)), "grads": grads}


STEPS = {"global_cl": lambda d: cl_step(d, "global_cl"), "local_cl": lambda d: cl_step(d, "local_cl"),
         "finetune": finetune_step}


def step_cases(rank: int, world: int, inputs: str, out: str, shape, axes) -> None:
    """The cases of ``inputs`` on mesh ``shape`` over ``axes``, then, with a
    spatial axis, the controls that must miss JAX's step: views cropped from
    each rank's own rows, LocalCL's boxes cut from its own rows of the
    decoder map. Beside the results: this rank's (data rank, data ranks,
    rows its data rank reads of its 2)."""
    from tedm_tpu_torch.models import contrastive as tc
    from tedm_tpu_torch.parallel import mesh
    from tedm_tpu_torch.trainers import contrastive

    mesh.make_mesh(tuple(shape), tuple(axes))
    d = torch.load(inputs, weights_only=False)
    res: Dict[Any, Any] = {case: STEPS[case](d[case]) for case in d}
    res["where"] = (mesh.data_rank(), mesh.data_world(), mesh.rows_seen(2))
    for case in ("global_cl", "local_cl") if "spatial" in axes else ():
        if case in d:
            res[case, "views cropped from local rows"] = cl_step(d[case], case, local_crops(d[case]["draws"]))
    if "local_cl" in d and "spatial" in axes:
        class NoGather:  # the models' spatial module with gather_h taken out
            gather_h = staticmethod(lambda x: x)

        with patched(tc, "spatial", NoGather), \
                patched(contrastive, "region_rows", local_boxes(contrastive.region_rows)):
            res["local_cl", "boxes from local rows"] = STEPS["local_cl"](d["local_cl"])
    torch.save(res, os.path.join(out, f"steps{rank}.pt"))


# ------------------------------------------------------------- the eval CLIs


def eval_cases(rank: int, world: int, runs: Dict[str, str]) -> None:
    """The eval CLIs with ``--multihost`` over each run of ``runs`` {name:
    experiment dir} (its config shards spatially; rank 0 writes the npz
    files), on the first 5 images of each test set."""
    from tedm_tpu_torch.eval import run_tests, testing_shared_weights
    from torch_parallel_worker import small_sets

    for name, exp_dir in runs.items():
        cli = testing_shared_weights if name == "testing_shared_weights" else run_tests
        with patched(cli, "build_test_loaders", small_sets(cli.build_test_loaders)):
            cli.main(["-e", exp_dir, "--multihost", "--rerun"], device="cpu")
