"""Checkpoints of the port: the JAX package's directory contract
(``tedm_tpu/utils/checkpoint.py``), with a torch file for the state.

Layout (a directory):
    <path>/state.pt       ``torch.save`` of a dict of state_dicts (tensors only)
    <path>/config.json    the Config that produced it, the same JSON as the
                          JAX package writes
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import torch

from tedm_tpu_torch.config import Config, diff_configs
from tedm_tpu_torch.parallel import mesh


def save_checkpoint(path: str, state: Dict[str, Any], config: Config) -> None:
    """Write ``state`` (a dict of state_dicts) and ``config`` under ``path``;
    in a data-parallel run rank 0 writes, and every rank returns once the
    checkpoint is there (a rank may read it next)."""
    if mesh.rank() == 0:
        path = os.path.abspath(path)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))
        config.save(os.path.join(path, "config.json"))
    mesh.barrier()


def load_config(path: str) -> Config:
    return Config.load(os.path.join(os.path.abspath(path), "config.json"))


def load_checkpoint(
    path: str,
    config: Optional[Config] = None,
    map_location: Any = "cpu",
    verbose: bool = True,
) -> Tuple[Dict[str, Any], Config]:
    """Returns (state, embedded config); with ``config`` given, reports the
    keys that drifted (reference: trainers/utils.py:154-174). Only tensors
    and plain containers are unpickled (``weights_only``)."""
    path = os.path.abspath(path)
    old_config = load_config(path)
    if config is not None and verbose:
        diff_configs(old_config, config)
    state = torch.load(os.path.join(path, "state.pt"), map_location=map_location, weights_only=True)
    return state, old_config


def checkpoint_exists(path: str) -> bool:
    return os.path.isfile(os.path.join(os.path.abspath(path), "state.pt"))
