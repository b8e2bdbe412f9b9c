"""Evaluation plumbing for ``run_tests`` and ``testing_shared_weights`` (port
of ``tedm_tpu/eval/harness.py``; reference: auxiliary/postprocessing/run_tests.py).

* Restore an experiment: ``<dir>/best/state.pt`` with ``config.json``
  beside it; the task is rebuilt from the embedded ``config.experiment``
  (the baseline and the two contrastive finetunes, which are baseline
  UNets; the LEDM/LEDMe/TEDM heads, PDDM; the reference's aliases
  ``datasetDM`` and ``simple_datasetDM`` too, run_tests.py:63-70) and each of
  its modules loads the state_dict under its key.
* The four test sets: JSRT val and test (the split CSVs), NIH and
  Montgomery, or their synthetic stand-ins (run_tests.py:83-91).
* Sigmoid predictions per set (step-major over the timesteps of a folded
  head), per-image Dice, precision and recall, and ``.npz`` files with the
  JAX package's keys.

* The conditional chain (tedm_tpu/eval/harness.py:136-225): a diffusion
  backbone restored with its EMA weights (unless ``serve_raw_params``),
  segmentations sampled conditioned on [x, 2 img - 1] by DDIM under
  ``--ddim_steps`` > 0, else by the full T-step ancestral loop, the mean of
  ``n_runs`` trajectories a batch.

* Sharded evaluation (``eval_parallel_setup``, tedm_tpu/eval/harness.py:124-133):
  in a data-parallel run each batch's rows are split over the ranks and
  gathered back in order. Every rank draws the noise of the whole batch
  from the same generator and keeps its rows, so the predictions of any
  number of ranks are those of one. On a mesh with a ``model`` axis the
  rows are split over the data group, and under ``--param_sharding tp``
  the modules go through the ``tp`` rule, as JAX puts params and
  batch_stats through it (tedm_tpu/eval/run_tests.py:66-69). Under
  ``--shard_spatial`` each rank of a spatial group predicts its rows of H
  of its images (``parallel/spatial.py``), every noise drawn whole and cut:
  the predictions stay this rank's rows until ``compute_output``, which
  adds each image's counts over the row shards for its metrics and
  gathers the images along H, so that the npz files and the metrics are
  one process's.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.datasets import MonDataset, NIHDataset, SyntheticCXRDataset
from tedm_tpu_torch.data.pipeline import Loader, build_dataloaders
from tedm_tpu_torch.ops import metrics as M
from tedm_tpu_torch.parallel import mesh, spatial, tensor_parallel
from tedm_tpu_torch.trainers.common import to_nchw
from tedm_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, load_config
from tedm_tpu_torch.utils.device import resolve_device

DATASET_KEYS = ("JSRT_val", "JSRT_test", "NIH", "Montgomery")
# the contrastive finetunes are baseline UNets (tedm_tpu/eval/harness.py:60-63)
BASELINE_EXPERIMENTS = ("baseline", "global_finetune", "glob_loc_finetune")
DATASETDM_EXPERIMENTS = ("LEDM", "LEDMe", "TEDM", "datasetDM")
PDDM_EXPERIMENTS = ("PDDM", "simple_datasetDM")


def build_eval_task(config: Config, device: Union[str, torch.device] = "cuda"):
    """Experiment name -> task on ``device`` (reference model pick,
    run_tests.py:63-70). PDDM skips its standardisation pre-pass: the
    checkpoint's statistics overwrite it."""
    exp = config.experiment
    if exp in BASELINE_EXPERIMENTS:
        from tedm_tpu_torch.trainers.baseline import build_task

        return build_task(config, device)
    if exp in DATASETDM_EXPERIMENTS:
        from tedm_tpu_torch.trainers.datasetdm import build_task

        return build_task(config, device)
    if exp in PDDM_EXPERIMENTS:
        from tedm_tpu_torch.trainers.per_step import build_task

        return build_task(config, device, compute_stats=False)
    raise ValueError(f"Experiment {exp} not recognized")


def load_experiment(exp_dir: str, device: Union[str, torch.device] = "cuda") -> Tuple[Config, Any]:
    """Restore (config, task) from an experiment directory, on ``device``."""
    dev = resolve_device(device)
    if not os.path.isdir(exp_dir):
        raise ValueError("Experiment path is not a directory")
    ckpt = os.path.join(exp_dir, "best")
    if not checkpoint_exists(ckpt):
        raise ValueError(f"No checkpoint found in {exp_dir} (expected best/state.pt)")
    config = load_config(ckpt)
    task = build_eval_task(config, dev)
    state, _ = load_checkpoint(ckpt, config, map_location=dev)
    for name, module in task.modules.items():
        module.load_state_dict(state[name])
    return config, task


def build_jsrt_loaders(config: Config) -> Dict[str, Loader]:
    return build_dataloaders(
        "JSRT", config.data_dir, config.img_size, config.batch_size,
        config.num_workers, config.n_labelled_images, seed=config.seed,
        synthetic=config.synthetic_data, splits_dir=config.splits_dir,
    )


def build_test_loaders(
    config: Config,
    nih_path: Optional[str] = None,
    mon_path: Optional[str] = None,
    mon_csv: str = "patient_data.csv",
) -> Dict[str, Loader]:
    """The four eval sets (reference: run_tests.py:83-91). With synthetic
    data (or a path missing) NIH and Montgomery are synthetic stand-ins of
    the reference sizes, 100 each."""
    jsrt = build_jsrt_loaders(config)
    mk = lambda ds: Loader(ds, config.batch_size, num_workers=config.num_workers)
    out = {"JSRT_val": jsrt["val"], "JSRT_test": jsrt["test"]}
    sdir = config.splits_dir
    if config.synthetic_data or nih_path is None:
        out["NIH"] = mk(SyntheticCXRDataset("nih", 100, config.img_size, seed=config.seed))
    else:
        nih_kw = {"splits_dir": sdir} if sdir else {}
        out["NIH"] = mk(NIHDataset(nih_path, img_size=config.img_size, **nih_kw))
    if config.synthetic_data or mon_path is None:
        out["Montgomery"] = mk(SyntheticCXRDataset("montgomery", 100, config.img_size, seed=config.seed))
    else:
        # Montgomery's CSV ships with its images (the reference's MONPATH is
        # also its csv path, run_tests.py:88-90) unless splits_dir overrides it
        out["Montgomery"] = mk(MonDataset(mon_path, mon_csv, img_size=config.img_size,
                                          splits_dir=sdir or mon_path))
    return out


def eval_parallel_setup(
    config: Config, modules: Iterable[torch.nn.Module] = ()
) -> Tuple[Optional[Tuple[int, int]], Optional[spatial.Plan]]:
    """(data rank, data ranks) when the ranks of a data-parallel run share
    each batch of ``config.batch_size`` rows, else None (one rank, or a
    batch the data ranks do not divide: every rank then predicts every
    row), as JAX's wiring is the identity on one device or an indivisible
    batch; and the spatial plan of the batches under ``--shard_spatial``
    (``spatial.plan_for`` of ``config.img_size`` rows), else None. With a
    process group it builds ``config``'s mesh, and under
    ``--param_sharding tp`` shards ``modules`` over its model group."""
    if not mesh.active():
        return None, None
    mesh.check_config(config)
    mesh.make_mesh(tuple(config.mesh_shape), tuple(config.mesh_axes))
    n = mesh.data_world()
    if config.batch_size % n:
        return None, None
    if config.param_sharding == "tp":
        for module in modules:
            tensor_parallel.shard(module, mesh.model_plan(), config.tp_min_width)
    plan = None
    if config.shard_spatial:
        plan = spatial.plan_for(mesh.spatial_plan(), config.img_size, len(config.dim_mults) - 1)
    return ((mesh.data_rank(), n) if n > 1 else None), plan


def _rows(shard: Optional[Tuple[int, int]], b: int) -> Optional[slice]:
    """This rank's rows of a batch of ``b``, None when unsharded."""
    if shard is None or b % shard[1]:
        return None
    per = b // shard[1]
    return slice(shard[0] * per, (shard[0] + 1) * per)


def _step_rows(a: torch.Tensor, steps: int, rows: slice) -> torch.Tensor:
    """``rows`` of each step of a step-major (steps * b, ...) tensor."""
    return a.reshape(steps, -1, *a.shape[1:])[:, rows].reshape(-1, *a.shape[1:])


def _gather_step_major(pred: torch.Tensor, steps: int) -> torch.Tensor:
    """Every rank's step-major (steps * b_rank, ...) rows as the global
    batch's step-major (steps * b, ...) rows."""
    per_rank = pred.reshape(steps, -1, *pred.shape[1:]).transpose(0, 1).contiguous()
    return mesh.gather_rows(per_rank).transpose(0, 1).reshape(-1, *pred.shape[1:])


def load_diffusion_experiment(
    exp_dir: str, device: Union[str, torch.device] = "cuda"
) -> Tuple[Config, torch.nn.Module, Any]:
    """Restore a diffusion checkpoint (img_only, joint, conditional) as
    (config, UNet in eval mode, schedule) on ``device``: the EMA weights
    when the checkpoint has them, unless its config sets
    ``serve_raw_params``."""
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers.diffusion import build_model

    dev = resolve_device(device)
    ckpt = os.path.join(exp_dir, "best")
    config = load_config(ckpt)
    state, _ = load_checkpoint(ckpt, map_location=dev, verbose=False)
    unet = build_model(config)
    unet.load_state_dict(state["params"] if config.serve_raw_params else state.get("ema_params", state["params"]))
    sched = make_schedule(config.timesteps, config.beta_schedule, config.p2_loss_weight_gamma,
                          config.p2_loss_weight_k)
    return config, unet.to(dev).eval().requires_grad_(False), sched.to(dev)


def make_conditional_sampler(config: Config, unet: torch.nn.Module, sched) -> Callable[..., torch.Tensor]:
    """``run_once(cond, generator=None, x_T=None, noises=None)``: one
    segmentation trajectory conditioned on ``cond`` (B, 1, H, W) in [-1, 1],
    in [0, 1] (run_tests.py:131). DDIM under ``config.ddim_steps`` > 0
    (``x_T`` and ``noises`` as ``ddim_sample_loop`` takes them), else the
    full ancestral loop from ``generator``."""
    from tedm_tpu_torch.models.diffusion import ddim_sample_loop, sample_loop

    @torch.inference_mode()
    def run_once(cond, generator=None, x_T=None, noises=None, rows=None, batch=None):
        """``rows``: the rows of a batch of ``batch`` that ``cond`` holds;
        every draw is made for the whole batch and cut to them."""
        apply_fn = lambda x, t: unet(torch.cat([x, cond], dim=1), t)
        shape = (cond.shape[0] if rows is None else batch, 1, *cond.shape[2:])
        kw = dict(objective=config.objective, dynamic_threshold_percentile=config.dynamic_threshold_percentile)
        if config.ddim_steps > 0:
            if rows is not None and x_T is None:  # the only draw at eta 0
                x_T = spatial.randn(shape, generator, sched.alphas_cumprod.device, torch.float32)[rows]
            x0 = ddim_sample_loop(apply_fn, sched, tuple(cond.shape[:1]) + shape[1:], generator,
                                  num_steps=config.ddim_steps, x_T=x_T, noises=noises, **kw)
        else:
            x0 = sample_loop(apply_fn, sched, shape, generator, rows=rows, **kw)
        return x0 * 0.5 + 0.5

    return run_once


def predict_conditional_dataset(
    config: Config,
    unet: torch.nn.Module,
    sched,
    loader,
    generator: Optional[torch.Generator] = None,
    n_runs: int = 5,
    run_once: Optional[Callable[..., torch.Tensor]] = None,
    draws: Optional[Iterable[Tuple[torch.Tensor, Optional[Sequence[torch.Tensor]]]]] = None,
    shard: Optional[Tuple[int, int]] = None,
    plan: Optional[spatial.Plan] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's costliest inference (run_tests.py:121-137): per batch,
    the mean of ``n_runs`` trajectories of the segmentation conditioned on
    the image, as (y_hat, y_star) NHWC numpy without the padding rows.
    ``draws`` gives each run's (x_T, DDIM noises), NCHW, batch by batch;
    else they come from ``generator``. Pass a ``run_once`` built once
    (``make_conditional_sampler``) when evaluating several sets. ``shard``
    (``eval_parallel_setup``) splits each batch's rows over the ranks;
    under its spatial ``plan`` the predictions are this rank's rows of H
    (``compute_output`` gathers them) and the masks whole."""
    run_once = run_once or make_conditional_sampler(config, unet, sched)
    dev = next(unet.parameters()).device
    draws = None if draws is None else iter(draws)
    y_hats, y_stars = [], []
    for batch in loader:
        cond = to_nchw(batch["image"], dev) * 2.0 - 1.0
        b = cond.shape[0]
        rows = _rows(shard, b)
        runs = []
        with spatial.sharded(plan):
            cond = spatial.local_rows(cond)
            h_rows = lambda a: None if a is None else spatial.local_rows(a.to(dev))
            for _ in range(n_runs):
                x_T, noises = next(draws) if draws is not None else (None, None)
                x_T, noises = h_rows(x_T), None if noises is None else [h_rows(z) for z in noises]
                if rows is None:
                    runs.append(run_once(cond, generator, x_T, noises))
                else:
                    cut = lambda a: None if a is None else a[rows]
                    runs.append(run_once(cond[rows], generator, cut(x_T),
                                         None if noises is None else [cut(z) for z in noises], rows, b))
        pred = torch.stack(runs).mean(dim=0)
        if rows is not None:
            pred = mesh.gather_rows(pred)
        pred = pred.permute(0, 2, 3, 1).cpu().numpy()
        nvalid = int(batch["valid"].sum())
        y_hats.append(pred[:nvalid])
        y_stars.append(batch["mask"][:nvalid])
    return np.concatenate(y_hats), np.concatenate(y_stars)


def make_predict_fn(task) -> Callable[..., torch.Tensor]:
    """``fwd(x, generator=None, noise=None)``: sigmoid probabilities of an
    NCHW batch, (fold*B, C, H, W) fp32, without autograd. Noise as in
    ``extract_features``."""

    @torch.inference_mode()
    def fwd(x: torch.Tensor, generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.sigmoid(task.apply(x, generator=generator, noise=noise).float())

    return fwd


def predict_dataset(
    task,
    loader,
    generator: Optional[torch.Generator] = None,
    fold: int = 1,
    fwd: Optional[Callable[..., torch.Tensor]] = None,
    noise: Optional[Iterable[np.ndarray]] = None,
    shard: Optional[Tuple[int, int]] = None,
    plan: Optional[spatial.Plan] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sigmoid predictions over a loader: (y_hat, y_star), NHWC numpy, the
    padding rows dropped; y_hat is (fold, N, H, W, C), step-major, when
    fold > 1. The feature noise comes from ``generator``, or from ``noise``:
    one NHWC array a batch (B rows, or S*B step-major). ``shard``
    (``eval_parallel_setup``) splits each batch's rows over the ranks;
    under its spatial ``plan`` each rank predicts its rows of H, y_hat is
    those rows (``compute_output`` gathers them) and y_star whole."""
    dev = next(task.trained.parameters()).device
    fwd = fwd or make_predict_fn(task)
    noise = None if noise is None else iter(noise)
    steps = len(task.t_steps)  # the noise rows of an image (none for the baseline)
    y_hats, y_stars = [], []
    for batch in loader:
        x = to_nchw(batch["image"], dev)
        n = None if noise is None else to_nchw(next(noise), dev)
        rows = _rows(shard, x.shape[0])
        with spatial.sharded(plan):
            if rows is None:
                pred = fwd(spatial.local_rows(x), generator, None if n is None else spatial.local_rows(n))
            else:
                if n is None and steps:  # extract_features' draw, for the whole batch
                    n = torch.randn((steps * x.shape[0], *x.shape[1:]), generator=generator, device=dev)
                if n is not None:
                    n = spatial.local_rows(_step_rows(n, n.shape[0] // x.shape[0], rows))
                pred = _gather_step_major(fwd(spatial.local_rows(x[rows]), generator, n), fold)
        pred = pred.permute(0, 2, 3, 1).cpu().numpy()
        nvalid = int(batch["valid"].sum())
        b = len(batch["valid"])
        pred = pred.reshape(fold, b, *pred.shape[1:])[:, :nvalid] if fold > 1 else pred[:nvalid]
        y_hats.append(pred)
        y_stars.append(batch["mask"][:nvalid])
    return np.concatenate(y_hats, axis=1 if fold > 1 else 0), np.concatenate(y_stars, axis=0)


def compute_output(y_hat: np.ndarray, y_star: np.ndarray, plan: Optional[spatial.Plan] = None,
                   device: Union[str, torch.device] = "cpu") -> Dict[str, np.ndarray]:
    """The saved artifact (reference: run_tests.py:150-156): NHWC y_hat and
    y_star, and per-image (N, C) Dice, precision and recall of y_hat > 0.5.
    Under a spatial ``plan`` (``eval_parallel_setup``) y_hat is this rank's
    rows of H and y_star whole: the metrics add each image's counts over
    the row shards (``spatial.spatial_sum``), and the artifact holds y_hat
    gathered along H, on every rank; the reductions run on ``device``, the
    process group's."""
    nchw = lambda a: torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1))).to(device)
    pred = nchw(y_hat > 0.5)
    with spatial.sharded(plan):
        target, total = spatial.local_rows(nchw(y_star)), spatial.spatial_sum
        out = {name: fn(pred, target, total).cpu().numpy()
               for name, fn in (("dice", M.dice), ("precision", M.precision), ("recall", M.recall))}
        if plan is not None:
            y_hat = np.moveaxis(spatial.gather_h(nchw(y_hat)).cpu().numpy(), 1, -1)
        return {"y_hat": y_hat, "y_star": y_star, **out}


def print_metrics(name: str, output: Dict[str, np.ndarray]) -> None:
    """The reference's formatting (run_tests.py:157-159)."""
    print(f"{name} metrics: \n\tdice:      "
          f"{np.nanmean(output['dice']):.3}+/-{np.nanstd(output['dice']):.3}")
    print(f"\tprecision: {np.nanmean(output['precision']):.3}"
          f"+/-{np.nanstd(output['precision']):.3}")
    print(f"\trecall:    {np.nanmean(output['recall']):.3}"
          f"+/-{np.nanstd(output['recall']):.3}")


def save_output(path: str, output: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **output)


def load_output(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
