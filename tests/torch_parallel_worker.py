"""The ranks of the port's data-parallel tests (``tests/test_torch_parallel_*.py``).

Adam runs as on the card, ``foreach`` (one kernel over many tensors, which
cannot mix FSDP's sharded parameters with its replicated ones).
``spawn`` starts ``world`` processes with the ``spawn`` start method, each
joining a gloo group through a ``FileStore`` under the test's temporary
directory (no TCP port), runs one of the functions below in each, and
waits for them with a timeout. The functions import only the port: they
read their inputs (numpy arrays made by the test from a seed) from a file
and write their results to files beside it, which the test, which holds
JAX, compares.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import time
import traceback
from typing import Any, Callable, Dict

import numpy as np
import torch

DIM, MULTS, SIZE, LR, TAU = 16, (1, 2), 32, 1e-3, 0.1
ONE_STAGE = (1,)  # a UNet of one stage compiles in half the time
# the CL steps' (dim_mults, img_size): GlobalCL's head flattens a one-stage
# UNet's mid at 16^2 (4096 inputs); LocalCL's reads the second decoder stage
CL_SHAPES = {"global_cl": (ONE_STAGE, 16), "local_cl": (MULTS, SIZE)}
FSDP_MIN = 64  # JAX's test of the FSDP rule uses it too (tests/test_dp_training.py)
GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def spawn(target: Callable, world: int, tmp: str, *args, timeout: float = 240) -> None:
    """Run ``target(rank, world, *args)`` in ``world`` processes of one gloo
    group; raise with a rank's traceback if any fails, or after ``timeout``
    seconds (the ranks are killed)."""
    ctx = torch.multiprocessing.get_context("spawn")
    store = os.path.join(tmp, f"store_{time.monotonic_ns()}")
    procs = [ctx.Process(target=_rank, args=(target, r, world, store, tmp, args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(f).read() for r in range(world) if os.path.exists(f := os.path.join(tmp, f"error{r}.txt"))]
    if hung or errors or any(p.exitcode for p in procs):
        raise RuntimeError(f"ranks {hung} still ran after {timeout} s; exit codes "
                           f"{[p.exitcode for p in procs]}\n" + "\n".join(errors))


def _rank(target, rank, world, store, tmp, args):
    import sys

    import torch.distributed as dist

    torch.set_num_threads(1)
    # rank 0's TensorBoard writer works without TensorFlow, whose import
    # (through tensorboard's compat layer, where it is installed) takes ~20 s
    sys.modules.setdefault("tensorflow", None)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                            timeout=GROUP_TIMEOUT)
    try:
        target(rank, world, *args)
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _numpy(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def _grads(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    from tedm_tpu_torch.parallel.mesh import _full

    return {n: _full(p.grad).numpy().copy() for n, p in module.named_parameters() if p.grad is not None}


# ------------------------------------------------------------- one step


def diffusion_step(rank, d, mode, accum):
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.parallel.mesh import DataParallel
    from tedm_tpu_torch.trainers import diffusion as D
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    cfg = Config(experiment="img_only", dim=DIM, dim_mults=ONE_STAGE, img_size=SIZE, batch_size=2, grad_accum=accum,
                 timesteps=1000, lr=LR)
    unet = load_numpy_state_dict(D.build_model(cfg), d["params"])
    dp = DataParallel(mode, FSDP_MIN)
    model = dp.wrap(unet)
    steps = D.make_steps(cfg, model, make_schedule(cfg.timesteps, cfg.beta_schedule),
                         torch.optim.Adam(dp.optimizer_params(unet.parameters()), lr=LR, foreach=True), None, dp)
    rows = slice(2 * rank, 2 * rank + 2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows]))
    loss, _ = steps.train_step(t(d["x"]), torch.zeros(1), t(d["valid"]), t=t(d["t"]), noise=t(d["noise"]))
    return {"loss": float(loss), "params": _numpy(dp.state_dict(unet)), "grads": _grads(unet)}


def head_step(rank, d, mode):
    from tedm_tpu_torch.models.segmentation import PixelClassifier
    from tedm_tpu_torch.models.unet import Unet
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.parallel.mesh import DataParallel
    from tedm_tpu_torch.trainers.common import make_train_step
    from tedm_tpu_torch.trainers.datasetdm import SegTask
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    unet = load_numpy_state_dict(Unet(dim=DIM, dim_mults=ONE_STAGE), d["backbone"]).eval().requires_grad_(False)
    clf = load_numpy_state_dict(
        PixelClassifier(stage_channels=tuple(DIM * m for m in reversed(ONE_STAGE)), n_steps=1, img_size=SIZE,
                        shared=True), d["classifier"])
    dp = DataParallel(mode, FSDP_MIN)
    steps = len(d["t_steps"])
    task = SegTask(unet=unet, classifier=dp.wrap(clf, find_unused=True), sched=make_schedule(1000, "cosine"),
                   t_steps=tuple(d["t_steps"]), normalize=True, fold=steps)
    step = make_train_step(task, torch.optim.Adam(dp.optimizer_params(task.classifier.parameters()), lr=LR,
                                                  foreach=True), (), dp)
    rows = slice(2 * rank, 2 * rank + 2)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[rows]))
    noise = d["noise"].reshape(steps, 4, *d["noise"].shape[1:])[:, rows].reshape(-1, *d["noise"].shape[1:])
    loss, per_fold = step(t(d["x"]), t(d["y"]), t(d["valid"]), noise=torch.from_numpy(np.ascontiguousarray(noise)))
    return {"loss": float(loss), "per_fold": per_fold.numpy().copy(), "params": _numpy(dp.state_dict(clf)),
            "grads": _grads(clf)}


def cl_step(rank, d, mode, experiment):
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.models import contrastive as tc
    from tedm_tpu_torch.parallel.mesh import DataParallel
    from tedm_tpu_torch.trainers import contrastive
    from tedm_tpu_torch.utils.convert import load_numpy_state_dict

    mults, size = CL_SHAPES[experiment]
    cfg = Config(experiment=experiment, dim=DIM, dim_mults=mults, img_size=size, batch_size=2, lr=LR,
                 tau=TAU).apply_experiment_preset()
    cls = tc.LocalCL if experiment == "local_cl" else tc.GlobalCL
    model = load_numpy_state_dict(cls(img_size=size, dim=DIM, dim_mults=mults), d["params"])
    contrastive.trainable_parameters(model)
    dp = DataParallel(mode, FSDP_MIN)
    forward = dp.wrap(model)
    optimizer = torch.optim.Adam(dp.optimizer_params(p for p in model.parameters() if p.requires_grad), lr=LR,
                                 foreach=True)
    steps = contrastive.make_steps(cfg, model, optimizer, forward, dp)
    views = d["views"]  # (8, 1, size, size): view 1 of the 4 images, then view 2
    mine = np.concatenate([views[2 * rank:2 * rank + 2], views[4 + 2 * rank:4 + 2 * rank + 2]])
    centres = tuple(torch.from_numpy(c) for c in d["centres"]) if experiment == "local_cl" else None
    loss = steps.train_step(None, views=torch.from_numpy(mine), centres=centres)
    return {"loss": float(loss), "params": _numpy(dp.state_dict(model)), "grads": _grads(model)}


def step_cases(rank: int, world: int, inputs: str, out: str) -> None:
    """Each step case of ``inputs`` under DDP and FSDP, and the controls of
    those cases (each one fix taken out, under DDP) that must miss JAX's
    step."""
    from tedm_tpu_torch.kernels import layouts
    from tedm_tpu_torch.models import segmentation
    from tedm_tpu_torch.parallel import mesh

    d = torch.load(inputs, weights_only=False)
    run = {"img_only": lambda mode: diffusion_step(rank, d["img_only"], mode, 1),
           "img_only accum 2": lambda mode: diffusion_step(rank, d["img_only accum 2"], mode, 2),
           "TEDM": lambda mode: head_step(rank, d["TEDM"], mode),
           "global_cl": lambda mode: cl_step(rank, d["global_cl"], mode, "global_cl"),
           "local_cl": lambda mode: cl_step(rank, d["local_cl"], mode, "local_cl")}
    res: Dict[Any, Any] = {}
    for mode in ("replicated", "fsdp"):
        epoch = layouts._epoch
        for case in d:
            res[case, mode] = run[case](mode)
        res["layout epochs", mode] = layouts._epoch - epoch

    def unweighted(per_row, valid):  # each rank's own masked mean, DDP's mean over the ranks
        return (per_row * valid).sum() / valid.sum().clamp(min=1.0) / mesh.world()

    if "TEDM" in d:
        with patched(segmentation, "all_reduce_sum", lambda t: t):
            res["TEDM", "per-rank BatchNorm"] = run["TEDM"]("replicated")
        with patched(mesh, "global_share", unweighted):
            res["TEDM", "unweighted DDP mean"] = run["TEDM"]("replicated")
    if "global_cl" in d:
        with patched(mesh, "world", lambda: 1):  # each rank's loss over its own rows
            res["global_cl", "per-rank NT-Xent"] = run["global_cl"]("replicated")
    if rank:  # the test reads rank 1's losses and parameters alone
        res = {k: {"loss": v["loss"], "params": v["params"]} for k, v in res.items() if isinstance(v, dict)}
    torch.save(res, os.path.join(out, f"steps{rank}.pt"))


# --------------------------------------------------------- entry points

CLI = ["--synthetic_data", "--dim", str(DIM), "--dim_mults", *map(str, ONE_STAGE), "--img_size", "16", "--batch_size",
       "2", "--timesteps", "20", "--val_steps", "4", "--n_sampled_imgs", "2", "--num_workers", "1"]


def signalled(on: bool, after: int):
    """A stand-in for ``graceful_shutdown`` whose flag rises, on this rank
    only when ``on``, at the ``after``-th step."""

    @contextlib.contextmanager
    def shutdown():
        calls = [0]

        def should_stop():
            calls[0] += 1
            return on and calls[0] >= after

        yield should_stop

    return shutdown


def small_sets(build):
    """``build_test_loaders`` cut to the first 5 images of each set (batches
    of 2, 2 and 1 plus a padding row)."""

    def build_test_loaders(config, *args, **kw):
        from tedm_tpu_torch.data.pipeline import Loader

        return {k: Loader(v.dataset, config.batch_size, num_workers=1, subset=5)
                for k, v in build(config, *args, **kw).items()}

    return build_test_loaders


def zero_noise_features(extract):
    def extract_features(*args, generator=None, noise=None, **kw):
        x = args[2]
        return extract(*args, noise=torch.zeros_like(x), **kw)

    return extract_features


def pddm_moments(tmp: str, device: str = "cpu") -> Dict[str, np.ndarray]:
    """The PDDM probe's standardisation statistics from the pre-pass over
    this rank's shard of the train set (zero feature noise, so that the
    features are the same however the set is split)."""
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.data.pipeline import build_dataloaders
    from tedm_tpu_torch.parallel import mesh
    from tedm_tpu_torch.trainers import per_step

    cfg = Config(experiment="PDDM", dim=DIM, dim_mults=ONE_STAGE, img_size=16, batch_size=2, n_labelled_images=3,
                 standardize_features=True, saved_diffusion_model=os.path.join(tmp, "none"),
                 log_dir=os.path.join(tmp, "pddm")).apply_experiment_preset()
    loaders = build_dataloaders("JSRT", None, 16, 2, 1, 3, seed=0, synthetic=True, **mesh.loader_shard())
    with patched(per_step, "extract_features", zero_noise_features(per_step.extract_features)):
        task = per_step.build_task(cfg, device, loaders)
    return {"mean": task.classifier.mean.numpy().copy(), "std": task.classifier.std.numpy().copy()}


def cli_cases(rank: int, world: int, tmp: str) -> None:
    """``train.main(["--multihost", ...])`` and the eval CLIs on this rank,
    each rank under its own log root (rank 0's is ``r0``):
      * the backbone under FSDP, validated at step 2, rank 1 signalled at
        step 3: both ranks stop there and save; then resumed under FSDP
        from that checkpoint to step 5;
      * a TEDM head on it under DDP (n = 1: rank 1's shard is padding);
      * global_finetune under DDP, frozen encoder until step 3 (n = 3);
      * a conditional backbone under DDP, 1 step;
      * PDDM's pre-pass moments over the shards;
      * testing_shared_weights on the head and run_tests (DDIM, 2 steps) on
        the conditional backbone, sharing each batch, on the first 5
        images of each set.
    The scalars each rank logged are saved as ``logged{rank}.pt``."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.eval import run_tests, testing_shared_weights
    from tedm_tpu_torch.train import main as train_main
    from tedm_tpu_torch.trainers import diffusion
    from tedm_tpu_torch.utils import logging

    root = os.path.join(tmp, f"r{rank}")
    logged: Dict[str, list] = {}
    current: list = []
    log = logging.MetricsLogger.log

    def recording(self, metrics, step):
        current.append((step, {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}))
        return log(self, metrics, step)

    def run(name, argv):
        current.clear()
        train_main(["--multihost", *argv, *CLI], device="cpu")
        logged[name] = list(current)
        return config_from_args([*argv, *CLI]).log_dir.replace(root, os.path.join(tmp, "r0"))

    with patched(logging.MetricsLogger, "log", recording):
        with patched(diffusion, "graceful_shutdown", signalled(rank == 1, after=3)):
            run("backbone", ["--experiment", "img_only", "--param_sharding", "fsdp", "--fsdp_min_size", "64",
                             "--ema_decay", "0.9", "--max_steps", "4", "--val_freq", "2", "--log_freq", "1",
                             "--max_val_steps", "1", "--log_dir", os.path.join(root, "bb")])
        run("backbone resumed", ["--experiment", "img_only", "--param_sharding", "fsdp", "--fsdp_min_size", "64",
                                 "--ema_decay", "0.9", "--max_steps", "5", "--val_freq", "100", "--log_freq", "1",
                                 "--ckpt_every", "5", "--log_dir", os.path.join(root, "bb2"),
                                 "--resume_path", os.path.join(tmp, "r0", "CXR14", "bb", "interrupted")])
        backbone = os.path.join(tmp, "r0", "CXR14", "bb", "best")
        head = run("TEDM", ["--experiment", "TEDM", "--n_labelled_images", "1", "--saved_diffusion_model", backbone,
                     "--max_steps", "2", "--val_freq", "2", "--log_freq", "1",
                     "--log_dir", os.path.join(root, "logs", "run")])
        run("finetune", ["--experiment", "global_finetune", "--n_labelled_images", "3",
                         "--unfreeze_weights_at_step", "3", "--max_steps", "3", "--ckpt_every", "1",
                         "--val_freq", "100", "--log_freq", "1", "--log_dir", os.path.join(root, "ft")])
        cond = run("conditional", ["--experiment", "conditional", "--max_steps", "1", "--val_freq", "1",
                            "--max_val_steps", "1", "--log_freq", "1", "--ddim_steps", "2",
                            "--log_dir", os.path.join(root, "cond")])
    logged["pddm"] = pddm_moments(root)
    with patched(testing_shared_weights, "build_test_loaders", small_sets(testing_shared_weights.build_test_loaders)):
        testing_shared_weights.main(["-e", head, "--multihost", "--rerun"], device="cpu")
    with patched(run_tests, "build_test_loaders", small_sets(run_tests.build_test_loaders)):
        run_tests.main(["-e", cond, "--multihost", "--rerun"], device="cpu")
    torch.save(logged, os.path.join(tmp, f"logged{rank}.pt"))
