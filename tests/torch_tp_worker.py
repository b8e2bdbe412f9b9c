"""The ranks of the port's tensor-parallel tests (``tests/test_torch_tp_*.py``).

Each function runs in every rank that ``torch_parallel_worker.spawn``
starts, builds the mesh ``(D, M)`` over ``("data", "model")`` and imports only
the port. Inputs come from a file the test wrote (numpy arrays from a
seed); results go to files beside it. Data rank d takes rows
``d * 4 / D`` on of the global batch of 4, as JAX lays the batch out over
``data``, and the ranks of one model group take the same rows.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from torch_parallel_worker import DIM, LR, ONE_STAGE, SIZE, _numpy, patched

TP_MIN = 16  # JAX's test of the tp rule shards at this width (tests/test_parallel.py)


def full_grads(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    from tedm_tpu_torch.parallel import tensor_parallel as tp

    return {n: (tp.all_gather(p.grad, p.tp, 0) if tp.is_sharded(p) else p.grad).numpy().copy()
            for n, p in module.named_parameters() if p.grad is not None}


def rule_bytes(module: torch.nn.Module, size: int) -> Dict[str, int]:
    """The parameter bytes a rank holds by the tp rule (a sharded
    parameter's bytes over the model axis's size), and all of them, of a
    module not yet sharded."""
    from tedm_tpu_torch.parallel import tensor_parallel as tp

    plan = tp.plan_of(module, size, TP_MIN)
    full = {n: p.numel() * p.element_size() for n, p in module.named_parameters()}
    return {"rule": sum(b // size if plan[n] else b for n, b in full.items()), "full": sum(full.values())}


def held_bytes(module: torch.nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in module.parameters())


def _rows(a: np.ndarray, steps: int = 1) -> torch.Tensor:
    """This data rank's rows of a step-major (steps * 4, ...) array."""
    from tedm_tpu_torch.parallel import mesh

    per = 4 // mesh.data_world()
    a = a.reshape(steps, 4, *a.shape[1:])[:, per * mesh.data_rank():per * (mesh.data_rank() + 1)]
    return torch.from_numpy(np.ascontiguousarray(a.reshape(-1, *a.shape[2:])))


def backbone_step(d) -> Dict[str, Any]:
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.parallel import mesh, tensor_parallel
    from tedm_tpu_torch.trainers import diffusion as D
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    cfg = Config(experiment="img_only", dim=DIM, dim_mults=ONE_STAGE, img_size=SIZE, batch_size=2, timesteps=1000,
                 lr=LR)
    unet = load_numpy_state_dict(D.build_model(cfg), d["params"])
    nbytes = rule_bytes(unet, mesh.model_world())
    dp = mesh.DataParallel("tp", tp_min_width=TP_MIN)
    model = dp.wrap(unet)
    steps = D.make_steps(cfg, model, make_schedule(cfg.timesteps, cfg.beta_schedule),
                         torch.optim.Adam(unet.parameters(), lr=LR, foreach=True), None, dp)
    widths = []  # (local, gathered) channels of every gather of activations
    gather = tensor_parallel.gather

    def watched(y, plan, dim):
        out = gather(y, plan, dim)
        if not y.requires_grad or y.grad_fn is not None:  # activations, not a weight
            widths.append((y.shape[dim], out.shape[dim]))
        return out

    with patched(tensor_parallel, "gather", watched):
        loss, _ = steps.train_step(_rows(d["x"]), torch.zeros(1), _rows(d["valid"]), t=_rows(d["t"]),
                                   noise=_rows(d["noise"]))
    return {"loss": float(loss), "params": _numpy(dp.state_dict(unet)), "grads": full_grads(unet),
            "widths": widths, "bytes": {**nbytes, "held": held_bytes(unet)}}


def head_step(d) -> Dict[str, Any]:
    from tedm_tpu_torch.models.segmentation import PixelClassifier
    from tedm_tpu_torch.models.unet import Unet
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.parallel import mesh
    from tedm_tpu_torch.trainers.common import make_train_step
    from tedm_tpu_torch.trainers.datasetdm import SegTask
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    unet = load_numpy_state_dict(Unet(dim=DIM, dim_mults=ONE_STAGE), d["backbone"]).eval().requires_grad_(False)
    clf = load_numpy_state_dict(
        PixelClassifier(stage_channels=tuple(DIM * m for m in reversed(ONE_STAGE)), n_steps=1, img_size=SIZE,
                        shared=True), d["classifier"])
    nbytes, bb_bytes = rule_bytes(clf, mesh.model_world()), rule_bytes(unet, mesh.model_world())
    dp = mesh.DataParallel("tp", tp_min_width=TP_MIN)
    dp.place(unet)  # the frozen backbone goes through the rule, as JAX's batch_stats do
    steps = len(d["t_steps"])
    task = SegTask(unet=unet, classifier=dp.wrap(clf, find_unused=True), sched=make_schedule(1000, "cosine"),
                   t_steps=tuple(d["t_steps"]), normalize=True, fold=steps)
    step = make_train_step(task, torch.optim.Adam(clf.parameters(), lr=LR, foreach=True), (), dp)
    loss, per_fold = step(_rows(d["x"]), _rows(d["y"]), _rows(d["valid"]), noise=_rows(d["noise"], steps))
    return {"loss": float(loss), "per_fold": per_fold.numpy().copy(), "params": _numpy(dp.state_dict(clf)),
            "grads": full_grads(clf), "bytes": {**nbytes, "held": held_bytes(clf)},
            "backbone_bytes": {**bb_bytes, "held": held_bytes(unet)}}


def step_cases(rank: int, world: int, inputs: str, out: str, shape) -> None:
    """The backbone and TEDM head steps of ``inputs`` under TP on mesh
    ``shape``, then the controls that must miss JAX's step: the model
    group's input-gradient sum taken out, and (with a data axis of more than
    one rank) the data axis's reductions taken over every rank."""
    from tedm_tpu_torch.parallel import mesh, tensor_parallel

    mesh.make_mesh(tuple(shape), ("data", "model"))
    d = torch.load(inputs, weights_only=False)
    run = {"img_only": lambda: backbone_step(d["img_only"]), "TEDM": lambda: head_step(d["TEDM"])}
    res: Dict[Any, Any] = {case: run[case]() for case in d}
    with patched(tensor_parallel, "enter", lambda x, plan: x):
        for case in d:
            res[case, "no input-gradient sum"] = run[case]()
    if mesh.data_world() > 1:
        with patched(mesh, "data_group", lambda: None):
            for case in d:
                res[case, "reductions over the world"] = run[case]()
    if rank:  # the test reads rank 0's results, and the others' losses and parameters
        res = {k: {"loss": v["loss"], "params": v["params"]} for k, v in res.items()}
    torch.save(res, os.path.join(out, f"steps{rank}.pt"))


# ------------------------------------------------------- save and resume

CLI = ["--synthetic_data", "--dim", str(DIM), "--dim_mults", *map(str, ONE_STAGE), "--img_size", "16",
       "--batch_size", "2", "--timesteps", "20", "--num_workers", "1", "--lr", str(LR), "--log_freq", "1",
       "--val_freq", "100", "--ckpt_every", "1"]
TP = ["--multihost", "--mesh_shape", "1", "2", "--mesh_axes", "data", "model", "--param_sharding", "tp",
      "--tp_min_width", str(TP_MIN)]


def cli_run(argv, tp: bool = True) -> list:
    """``train.main(argv + CLI)`` on the CPU, under TP (``--multihost``,
    mesh (1, 2)) or in one process; returns the logged (step, loss) pairs
    and, per step, the full gradients the optimizer used, in its order."""
    from torch.optim.optimizer import register_optimizer_step_pre_hook

    from tedm_tpu_torch.parallel import tensor_parallel
    from tedm_tpu_torch.train import main as train_main
    from tedm_tpu_torch.utils import logging

    logged, grads = [], []
    log = logging.MetricsLogger.log

    def recording(self, metrics, step):
        if "train/loss" in metrics:
            logged.append((step, float(metrics["train/loss"])))
        return log(self, metrics, step)

    def keep_grads(optimizer, *_):
        grads.append([(tensor_parallel.all_gather(p.grad, p.tp, 0) if tensor_parallel.is_sharded(p)
                       else p.grad).numpy().copy() for g in optimizer.param_groups for p in g["params"]])

    handle = register_optimizer_step_pre_hook(keep_grads)
    try:
        with patched(logging.MetricsLogger, "log", recording):
            train_main([*argv, *CLI, *(TP if tp else [])], device="cpu")
    finally:
        handle.remove()
    return [logged, grads]


def resume_cases(rank: int, world: int, tmp: str, runs) -> None:
    """The TP runs ``runs`` {name: argv} in turn, every rank on the same log
    directory (rank 0 writes); rank 0 saves what each logged as
    ``{name}.pt``."""
    for name, argv in runs.items():
        out = cli_run(argv)
        if rank == 0:
            torch.save(out, os.path.join(tmp, f"{name}.pt"))
