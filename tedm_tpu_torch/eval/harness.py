"""Restore an experiment for evaluation or serving (port of
``load_experiment`` and ``build_eval_task`` in ``tedm_tpu/eval/harness.py``).

An experiment directory holds ``best/state.pt`` and ``best/config.json``;
the state carries the ``backbone`` and ``classifier`` state_dicts. The
dataset loops and metrics of the eval harness wait for a later slice.
"""

from __future__ import annotations

import os
from typing import Tuple, Union

import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.trainers.datasetdm import SegTask, build_task
from tedm_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, load_config
from tedm_tpu_torch.utils.device import resolve_device

DATASETDM_EXPERIMENTS = ("LEDM", "LEDMe", "TEDM", "datasetDM")


def build_eval_task(config: Config, device: Union[str, torch.device] = "cuda") -> SegTask:
    """Experiment name -> task (reference model pick, run_tests.py:63-70)."""
    if config.experiment in DATASETDM_EXPERIMENTS:
        return build_task(config, device)
    raise NotImplementedError(
        f"experiment {config.experiment!r} is not ported yet: the port serves "
        f"{', '.join(DATASETDM_EXPERIMENTS[:3])}; the baseline, contrastive and "
        "PDDM heads are ROADMAP item A.5"
    )


def load_experiment(
    exp_dir: str, device: Union[str, torch.device] = "cuda"
) -> Tuple[Config, SegTask]:
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
    task.unet.load_state_dict(state["backbone"])
    task.classifier.load_state_dict(state["classifier"])
    return config, task
