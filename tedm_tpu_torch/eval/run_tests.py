"""Batch evaluation (port of ``tedm_tpu/eval/run_tests.py``; reference:
auxiliary/postprocessing/run_tests.py).

    python -m tedm_tpu_torch.eval.run_tests --experiment <logdir>/<n>/<ts> [--rerun]
        [--nih_path DIR] [--mon_path DIR] [--ddim_steps N]
    torchrun --nproc_per_node N -m tedm_tpu_torch.eval.run_tests --multihost ...

Evaluates the checkpointed model on the card over JSRT_val, JSRT_test, NIH
and Montgomery, writes ``{dataset}_predictions.npz`` (keys: y_hat, y_star,
dice, precision, recall) into the experiment directory, prints mean+/-std
metrics, and skips the sets already evaluated unless ``--rerun``
(run_tests.py:40-49,107-113). For a folded (TEDM) head the prediction is
the sigmoid averaged over timesteps (``testing_shared_weights`` keeps the
per-timestep ones). A ``conditional`` diffusion backbone is evaluated by its
sampling chain: the mean of 5 trajectories conditioned on each image, by
DDIM under ``--ddim_steps`` > 0 (the checkpoint config's, unless the flag
is given here), else by the full ancestral loop (run_tests.py:121-137). The noise comes from a generator seeded with
``config.seed + 777``. Under ``--multihost`` the ranks share each batch
(``harness.eval_parallel_setup``: its rows over the data ranks, its rows of
H over the spatial ranks of a ``--shard_spatial`` run's mesh) and rank 0
writes.

    torchrun --nproc_per_node 2 -m tedm_tpu_torch.eval.run_tests --multihost -e <dir of a run
        trained with --mesh_shape 1 2 --mesh_axes data spatial --shard_spatial>
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from tedm_tpu_torch.eval.harness import (
    DATASET_KEYS,
    build_test_loaders,
    compute_output,
    eval_parallel_setup,
    load_diffusion_experiment,
    load_experiment,
    make_conditional_sampler,
    load_output,
    make_predict_fn,
    predict_conditional_dataset,
    predict_dataset,
    print_metrics,
    save_output,
)
from tedm_tpu_torch.parallel import mesh
from tedm_tpu_torch.utils.checkpoint import load_config
from tedm_tpu_torch.utils.device import resolve_device, strict_fp32


def evaluate_experiment(
    exp_dir: str,
    rerun: bool = False,
    nih_path: Optional[str] = None,
    mon_path: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
    ddim_steps: Optional[int] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Evaluate ``exp_dir`` on ``device``; returns {dataset key: output}.
    ``ddim_steps`` replaces the conditional backbone's own setting."""
    files = set(os.listdir(exp_dir))
    results = {}
    if {f"{k}_predictions.npz" for k in DATASET_KEYS} <= files and not rerun:
        print("Experiment already tested")
        for key in DATASET_KEYS:
            out = load_output(os.path.join(exp_dir, f"{key}_predictions.npz"))
            print_metrics(key, out)
            results[key] = out
        return results

    dev = resolve_device(device)
    conditional = load_config(os.path.join(exp_dir, "best")).experiment == "conditional"
    if conditional:
        config, unet, sched = load_diffusion_experiment(exp_dir, dev)
        if ddim_steps is not None:
            config = config.replace(ddim_steps=ddim_steps)
        run_once = make_conditional_sampler(config, unet, sched)  # one sampler for the four sets
    else:
        config, task = load_experiment(exp_dir, dev)
        fwd = make_predict_fn(task)
    loaders = build_test_loaders(config, nih_path, mon_path)
    generator = torch.Generator(device=dev).manual_seed(config.seed + 777)
    shard, plan = eval_parallel_setup(config, (unet,) if conditional else task.modules.values())

    for key, loader in loaders.items():
        path = os.path.join(exp_dir, f"{key}_predictions.npz")
        if os.path.exists(path) and not rerun:
            print(f"{key} already tested")
            out = load_output(path)
            print_metrics(key, out)
            results[key] = out
            continue
        print(f"Testing {key} set")
        if conditional:
            y_hat, y_star = predict_conditional_dataset(config, unet, sched, loader, generator, run_once=run_once,
                                                        shard=shard, plan=plan)
        else:
            y_hat, y_star = predict_dataset(task, loader, generator, fold=task.fold, fwd=fwd, shard=shard, plan=plan)
            if task.fold > 1:
                y_hat = y_hat.mean(axis=0)  # ensemble over timesteps (app.py:79)
        out = compute_output(y_hat, y_star, plan, dev)
        print_metrics(key, out)
        if mesh.rank() == 0:
            save_output(path, out)
        results[key] = out
    return results


def main(argv: Optional[Sequence[str]] = None, device: Union[str, torch.device] = "cuda") -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment", "-e", type=str, required=True, help="Experiment path")
    parser.add_argument("--rerun", "-r", default=False, action="store_true", help="Run the test again")
    parser.add_argument("--nih_path", type=str, default=None)
    parser.add_argument("--mon_path", type=str, default=None)
    parser.add_argument("--ddim_steps", type=int, default=None,
                        help="conditional backbones: DDIM steps (0: the full ancestral loop)")
    parser.add_argument("--multihost", action="store_true",
                        help="one rank of a data-parallel evaluation launched by torchrun")
    args = parser.parse_args(argv)
    if os.path.isdir(args.experiment):
        print("Experiment path identified as a directory")
    else:
        raise ValueError("Experiment path is not a directory")
    strict_fp32()
    if args.multihost:
        device = mesh.init_multihost(device)
    evaluate_experiment(args.experiment, args.rerun, args.nih_path, args.mon_path, device, args.ddim_steps)


if __name__ == "__main__":
    main()
