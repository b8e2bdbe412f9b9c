"""The ranks of the port's spatial-parallel tests (``tests/test_torch_sp_*.py``).

Each function runs in every rank that ``torch_parallel_worker.spawn``
starts, builds the mesh ``(D, S)`` over ``("data", "spatial")`` and imports
only the port. Inputs come from numpy seeds or from a file the test wrote;
results go to files beside it. Data rank d takes rows ``d * 4 / D`` on of
the global batch of 4, as JAX lays the batch out over ``data``, and the
ranks of one spatial group take the same rows, whole: the trainers keep
each rank's rows of H.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from torch_parallel_worker import DIM, LR, ONE_STAGE, SIZE, _numpy, patched

# (kernel, stride, padding) of every convolution the UNet runs over more than one row
CONVS = {"3x3": (3, 1, 1), "7x7": (7, 1, 3), "4x4/2": (4, 2, 1)}
HALO_SHAPE = (2, 3, 16, 8)         # (B, C, H, W) of the halo checks
UNET = dict(dim=8, dim_mults=(1, 2))  # the UNet of the halo file's model checks, at 16^2
NARROW_SHAPE = (2, 3, 4, 8)        # 1 row a rank: the 7x7's halo reaches 3 ranks on
NARROW_UNET = 8                    # the halo file's UNet at 8^2: 2 rows a rank, then 1
UNET_PATHS = {"fp32": {}, "bf16": {"dtype": torch.bfloat16},
              "opt-in": {"fused_groupnorm": True, "fused_resblock": True, "flash_attention": True}}


def halo_inputs() -> Dict[str, np.ndarray]:
    """The halo checks' inputs, from a seed: a map, each conv's weights and
    bias and the gradient of its output, per-rank gradients of a gather."""
    rs = np.random.RandomState(0)
    b, c, h, w = HALO_SHAPE
    d = {"x": rs.standard_normal(HALO_SHAPE).astype(np.float32)}
    for name, (k, s, p) in CONVS.items():
        d[name + " w"] = rs.standard_normal((4, c, k, k)).astype(np.float32) / k
        d[name + " b"] = rs.standard_normal(4).astype(np.float32)
        d[name + " dy"] = rs.standard_normal((b, 4, (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1)).astype(np.float32)
    d["gather dy"] = rs.standard_normal((4, *HALO_SHAPE)).astype(np.float32)  # rank r's gradient of the gathered map
    d["sum x"] = rs.standard_normal((4, 5, 3)).astype(np.float32)  # rank r's summand
    d["unet x"] = rs.standard_normal((2, 1, 16, 16)).astype(np.float32)
    d["unet t"] = np.array([3, 700])
    d["unet dy"] = rs.standard_normal((2, 1, 16, 16)).astype(np.float32)
    d["narrow x"] = rs.standard_normal(NARROW_SHAPE).astype(np.float32)
    for name in ("3x3", "7x7"):
        d["narrow " + name + " dy"] = rs.standard_normal((2, 4, *NARROW_SHAPE[2:])).astype(np.float32)
    d["narrow unet x"] = rs.standard_normal((2, 1, NARROW_UNET, NARROW_UNET)).astype(np.float32)
    d["narrow unet dy"] = rs.standard_normal((2, 1, NARROW_UNET, NARROW_UNET)).astype(np.float32)
    return d


def unet_of(path: str) -> torch.nn.Module:
    from tedm_tpu_torch.models.unet import Unet

    torch.manual_seed(0)
    return Unet(**UNET, **UNET_PATHS[path])


def unet_step(path: str, x: torch.Tensor, t: torch.Tensor, dy: torch.Tensor) -> Dict[str, np.ndarray]:
    """One forward and backward of the halo file's UNet: its output (this
    rank's rows under a plan) and its parameters' gradients."""
    unet = unet_of(path)
    y = unet(x, t)
    (y.float() * dy).sum().backward()
    return {"y": y.detach().float().numpy().copy(),
            "grads": {n: p.grad.numpy().copy() for n, p in unet.named_parameters() if p.grad is not None}}


def halo_cases(rank: int, world: int, out: str) -> None:
    """The halo, the gather and the sum on a spatial axis of ``world``
    ranks, then the UNet on each path on this rank's rows; and the conv
    gradients again with the halo gradients' return taken out. Then the
    narrow cases: the 3x3 and 7x7 convs on a map of 1 row a rank, and the
    fp32 UNet at 8^2 (2 rows a rank, then 1)."""
    import torch.distributed as dist

    from tedm_tpu_torch.parallel import mesh, spatial

    mesh.make_mesh((1, world), ("data", "spatial"))
    plan = mesh.spatial_plan()
    assert (mesh.spatial_world(), mesh.spatial_rank(), mesh.data_world()) == (world, rank, 1)
    d = {k: torch.from_numpy(v) for k, v in halo_inputs().items()}
    res: Dict[Any, Any] = {}

    def conv_case(name, pre=""):
        k, s, p = CONVS[name]
        conv = torch.nn.Conv2d(HALO_SHAPE[1], 4, k, stride=s, padding=p)
        w, b = d[name + " w"].clone().requires_grad_(), d[name + " b"].clone().requires_grad_()
        x = spatial.local_rows(d[pre + "x"]).requires_grad_()
        y = spatial.conv2d(conv, x, w, b)
        (y * spatial.local_rows(d[pre + name + " dy"])).sum().backward()
        return {"y": y.detach().numpy().copy(), "dx": x.grad.numpy().copy(),
                "dw": w.grad.numpy().copy(), "db": b.grad.numpy().copy()}

    with spatial.sharded(plan):
        for name in CONVS:
            res[name] = conv_case(name)
        with patched(spatial, "return_halo_grads", lambda own, *_: own):
            for name in CONVS:
                res[name, "no halo gradient return"] = conv_case(name)
        x = spatial.local_rows(d["x"]).requires_grad_()
        g = spatial.gather_h(x)
        (g * d["gather dy"][rank]).sum().backward()
        res["gather"] = {"y": g.detach().numpy().copy(), "dx": x.grad.numpy().copy()}
        v = d["sum x"][rank].clone().requires_grad_()
        s = spatial.spatial_sum(v)
        (s * (rank + 1)).sum().backward()
        res["sum"] = {"y": s.detach().numpy().copy(), "dx": v.grad.numpy().copy()}
        for name in ("3x3", "7x7"):
            res["narrow", name] = conv_case(name, "narrow ")
        for path, pre in [*((path, "") for path in UNET_PATHS), ("fp32", "narrow ")]:
            r = unet_step(path, spatial.local_rows(d[pre + "unet x"]), d["unet t"],
                          spatial.local_rows(d[pre + "unet dy"]))
            for n, gr in r["grads"].items():  # the gradient of the whole map's loss: the ranks' parts added
                gt = torch.from_numpy(gr)
                dist.all_reduce(gt, group=plan.group)
                r["grads"][n] = gt.numpy()
            res["unet", pre + path] = r
    torch.save(res, os.path.join(out, f"halo{rank}.pt"))


# ------------------------------------------------------------- one step


def _rows(a: np.ndarray, steps: int = 1) -> torch.Tensor:
    """This data rank's rows of a step-major (steps * 4, ...) array, whole."""
    from tedm_tpu_torch.parallel import mesh

    per = 4 // mesh.data_world()
    a = a.reshape(steps, 4, *a.shape[1:])[:, per * mesh.data_rank():per * (mesh.data_rank() + 1)]
    return torch.from_numpy(np.ascontiguousarray(a.reshape(-1, *a.shape[2:])))


def _grads(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {n: p.grad.numpy().copy() for n, p in module.named_parameters() if p.grad is not None}


def _dp():
    from tedm_tpu_torch.parallel import mesh

    return mesh.DataParallel("replicated", shard_spatial=True)


def backbone_step(d) -> Dict[str, Any]:
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers import diffusion as D
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    cfg = Config(experiment="img_only", dim=DIM, dim_mults=ONE_STAGE, img_size=SIZE, batch_size=2, timesteps=1000,
                 lr=LR)
    unet = load_numpy_state_dict(D.build_model(cfg), d["params"])
    dp = _dp()
    steps = D.make_steps(cfg, dp.wrap(unet), make_schedule(cfg.timesteps, cfg.beta_schedule),
                         torch.optim.Adam(unet.parameters(), lr=LR, foreach=True), None, dp)
    loss, _ = steps.train_step(_rows(d["x"]), torch.zeros(1), _rows(d["valid"]), t=_rows(d["t"]),
                               noise=_rows(d["noise"]))
    return {"loss": float(loss), "params": _numpy(dp.state_dict(unet)), "grads": _grads(unet)}


def head_task(d, classifier, dp, fold):
    from tedm_tpu_torch.models.unet import Unet
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers.datasetdm import SegTask
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    unet = load_numpy_state_dict(Unet(dim=DIM, dim_mults=ONE_STAGE), d["backbone"]).eval().requires_grad_(False)
    return SegTask(unet=unet, classifier=dp.wrap(classifier, find_unused=True), sched=make_schedule(1000, "cosine"),
                   t_steps=tuple(d["t_steps"]), normalize=True, fold=fold)


def head_step(d) -> Dict[str, Any]:
    """The TEDM head (``"classifier"``) or PDDM's probe (``"probe"``) on a
    frozen backbone."""
    from tedm_tpu_torch.models.segmentation import LinearProbe, PixelClassifier
    from tedm_tpu_torch.trainers.common import make_train_step
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    stages = tuple(DIM * m for m in reversed(ONE_STAGE))
    steps = len(d["t_steps"])
    if "probe" in d:
        head = load_numpy_state_dict(LinearProbe(stage_channels=stages, n_steps=steps, img_size=SIZE), d["probe"])
    else:
        head = load_numpy_state_dict(PixelClassifier(stage_channels=stages, n_steps=1, img_size=SIZE, shared=True),
                                     d["classifier"])
    dp = _dp()
    task = head_task(d, head, dp, 1 if "probe" in d else steps)
    step = make_train_step(task, torch.optim.Adam(head.parameters(), lr=LR, foreach=True), (), dp)
    loss, per_fold = step(_rows(d["x"]), _rows(d["y"]), _rows(d["valid"]), noise=_rows(d["noise"], steps))
    return {"loss": float(loss), "per_fold": per_fold.numpy().copy(), "params": _numpy(dp.state_dict(head)),
            "grads": _grads(head)}


def baseline_step(d) -> Dict[str, Any]:
    from tedm_tpu_torch.models.unet import Unet
    from tedm_tpu_torch.trainers.baseline import BaselineTask
    from tedm_tpu_torch.trainers.common import make_train_step
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    unet = load_numpy_state_dict(Unet(dim=DIM, dim_mults=ONE_STAGE), d["params"])
    dp = _dp()
    task = BaselineTask(unet=dp.wrap(unet, find_unused=True))
    step = make_train_step(task, torch.optim.Adam(unet.parameters(), lr=LR, foreach=True), (), dp)
    loss, _ = step(_rows(d["x"]), _rows(d["y"]), _rows(d["valid"]))
    return {"loss": float(loss), "params": _numpy(dp.state_dict(unet)), "grads": _grads(unet)}


STEPS = {"img_only": backbone_step, "TEDM": head_step, "baseline": baseline_step, "PDDM": head_step}


class _DataOnly(torch.autograd.Function):
    """An all-reduce over the data group alone, forward and backward: the
    control's BatchNorm, which leaves the row shards out."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        from tedm_tpu_torch.parallel import mesh

        y = x.clone()
        dist.all_reduce(y, group=mesh.data_group())
        return y

    @staticmethod
    def backward(ctx, g):
        return _DataOnly.forward(ctx, g)


def step_cases(rank: int, world: int, inputs: str, out: str, shape) -> None:
    """The step cases of ``inputs`` under spatial parallelism on mesh
    ``shape``, then the controls that must miss JAX's step: GroupNorm with
    each rank's own statistics, and BatchNorm reduced over the data group
    alone."""
    from tedm_tpu_torch.kernels.groupnorm import group_stats
    from tedm_tpu_torch.models import segmentation
    from tedm_tpu_torch.parallel import mesh, spatial

    mesh.make_mesh(tuple(shape), ("data", "spatial"))
    d = torch.load(inputs, weights_only=False)
    res: Dict[Any, Any] = {"where": (mesh.data_rank(), mesh.spatial_rank(), mesh.data_world(), mesh.spatial_world())}
    for case in d:
        res[case] = STEPS[case](d[case])
    if "img_only" in d:
        with patched(spatial, "group_stats", lambda x, groups, eps: group_stats(x, groups, eps)):
            res["img_only", "GroupNorm without spatial_sum"] = STEPS["img_only"](d["img_only"])
    if "TEDM" in d:
        with patched(segmentation, "all_reduce_sum", _DataOnly.apply):
            res["TEDM", "BatchNorm over the data group"] = STEPS["TEDM"](d["TEDM"])
    torch.save(res, os.path.join(out, f"steps{rank}.pt"))


# ------------------------------------------------------------ train.main

SP = ["--multihost", "--mesh_shape", "1", "2", "--mesh_axes", "data", "spatial", "--shard_spatial"]


def cli_run(argv) -> Dict[str, Any]:
    """``train.main(argv)`` on the CPU; the logged train and validation
    losses, and the convolutions that took a halo (under a plan)."""
    from tedm_tpu_torch.parallel import spatial
    from tedm_tpu_torch.train import main as train_main
    from tedm_tpu_torch.utils import logging

    logged: Dict[str, Any] = {"train/loss": [], "val/loss": []}
    log = logging.MetricsLogger.log
    halo = spatial.halo
    convs = [0]

    def recording(self, metrics, step):
        for k in logged:
            if k in metrics:
                logged[k].append(float(metrics[k]))
        return log(self, metrics, step)

    def counted(x, above, below):
        convs[0] += spatial.plan() is not None
        return halo(x, above, below)

    with patched(logging.MetricsLogger, "log", recording), patched(spatial, "halo", counted):
        train_main(argv, device="cpu")
    logged["sharded convs"] = convs[0]
    return logged


def cli_cases(rank: int, world: int, out: str, runs, evaluated: str) -> None:
    """The spatially sharded runs ``runs`` {name: argv} in turn, every rank
    on the same log directory (rank 0 writes), then the eval CLIs over the
    run ``evaluated`` (its config has ``--shard_spatial``) with
    ``--multihost``, on the first 5 images of each set; rank 0 saves what
    each run logged and the sets whose files each CLI wrote."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.eval import run_tests, testing_shared_weights
    from torch_parallel_worker import small_sets

    got: Dict[Any, Any] = {name: cli_run([*argv, *SP]) for name, argv in runs.items()}
    exp_dir = config_from_args([*runs[evaluated], *SP]).log_dir
    npz = lambda: sorted(f for f in os.listdir(exp_dir) if f.endswith("_predictions.npz"))
    for cli in (run_tests, testing_shared_weights):
        if rank == 0:  # the files of the last CLI, which only rank 0 writes and reads
            for f in npz():
                os.remove(os.path.join(exp_dir, f))
        with patched(cli, "build_test_loaders", small_sets(cli.build_test_loaders)):
            cli.main(["-e", exp_dir, "--multihost", "--rerun"], device="cpu")
        got[cli.__name__] = npz()
    if rank == 0:
        torch.save(got, os.path.join(out, "cli.pt"))
