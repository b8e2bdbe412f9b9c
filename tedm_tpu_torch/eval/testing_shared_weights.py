"""TEDM evaluation: per-timestep metrics and the timestep ensemble (port of
``tedm_tpu/eval/testing_shared_weights.py``; reference:
auxiliary/postprocessing/testing_shared_weights.py).

    python -m tedm_tpu_torch.eval.testing_shared_weights --experiment <dir> [--rerun]
        [--nih_path DIR] [--mon_path DIR]
    torchrun --nproc_per_node N -m tedm_tpu_torch.eval.testing_shared_weights --multihost ...

For each set, on the card: ``{dataset}_timestep{t}_predictions.npz`` for
every t of the checkpoint's ``t_steps_to_save``, and the ensembled
``{dataset}_predictions.npz`` (the sigmoid averaged over timesteps,
thresholded at 0.5 in the metrics), with the reference's printing. The
feature noise comes from a generator seeded with ``config.seed + 778``.
Under ``--multihost`` the ranks share each batch
(``harness.eval_parallel_setup``: its rows over the data ranks, its rows of
H over the spatial ranks of a ``--shard_spatial`` run's mesh) and rank 0
writes.
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
    load_experiment,
    make_predict_fn,
    predict_dataset,
    print_metrics,
    save_output,
)
from tedm_tpu_torch.parallel import mesh
from tedm_tpu_torch.utils.device import resolve_device, strict_fp32


def evaluate_shared_weights(
    exp_dir: str,
    rerun: bool = False,
    nih_path: Optional[str] = None,
    mon_path: Optional[str] = None,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Dict[str, np.ndarray]]:
    """Evaluate a TEDM ``exp_dir`` on ``device``; returns {dataset key:
    ensembled output} of the sets evaluated now, ``{}`` when all were done."""
    files = set(os.listdir(exp_dir))
    if {f"{k}_predictions.npz" for k in DATASET_KEYS} <= files and not rerun:
        print("Experiment already tested")
        return {}

    dev = resolve_device(device)
    config, task = load_experiment(exp_dir, dev)
    if not config.shared_weights_over_timesteps:
        raise ValueError(f"Experiment {config.experiment} not recognized "
                         "(expected a shared-weights TEDM checkpoint)")
    fwd = make_predict_fn(task)
    loaders = build_test_loaders(config, nih_path, mon_path)
    generator = torch.Generator(device=dev).manual_seed(config.seed + 778)
    shard, plan = eval_parallel_setup(config, task.modules.values())
    writes = mesh.rank() == 0
    results = {}

    for key, loader in loaders.items():
        if f"{key}_predictions.npz" in files and not rerun:
            print(f"{key} already tested")
            continue
        print(f"Testing {key} set")
        y_hats, y_star = predict_dataset(task, loader, generator, fold=task.fold, fwd=fwd, shard=shard, plan=plan)
        # y_hats (S, N, H, W, C), step-major as the reference's rearrange
        # '(b step) 1 h w -> step b 1 h w' (testing_shared_weights.py:120)
        for i, t in enumerate(config.t_steps_to_save):
            out = compute_output(y_hats[i], y_star, plan, dev)
            print_metrics(f"{key} {t}", out)
            if writes:
                save_output(os.path.join(exp_dir, f"{key}_timestep{t}_predictions.npz"), out)
        ens = compute_output(y_hats.mean(axis=0), y_star, plan, dev)
        print_metrics(key, ens)
        if writes:
            save_output(os.path.join(exp_dir, f"{key}_predictions.npz"), ens)
        results[key] = ens
    return results


def main(argv: Optional[Sequence[str]] = None, device: Union[str, torch.device] = "cuda") -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--experiment", "-e", type=str, required=True)
    parser.add_argument("--rerun", "-r", default=False, action="store_true")
    parser.add_argument("--nih_path", type=str, default=None)
    parser.add_argument("--mon_path", type=str, default=None)
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
    evaluate_shared_weights(args.experiment, args.rerun, args.nih_path, args.mon_path, device)


if __name__ == "__main__":
    main()
