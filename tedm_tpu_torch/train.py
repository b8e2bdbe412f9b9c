"""Experiment dispatcher (port of ``tedm_tpu/train.py``; reference: train.py:15-56).

    python -m tedm_tpu_torch.train --experiment {img_only,joint,conditional,
        joint_and_cond,baseline,LEDM,LEDMe,TEDM,PDDM,global_cl,local_cl,
        global_finetune,glob_loc_finetune} [--synthetic_data |
        --data_dir DIR [--splits_dir DIR]] [...]

The flags are the JAX package's (``tedm_tpu_torch.config.build_parser``).
Training runs on the card; ``main(argv, device="cpu")`` runs the plain
PyTorch path on the CPU. The flags whose features the port does not have
yet (ROADMAP item A.5h) raise ``NotImplementedError`` naming their
item.

Data parallel (``parallel/mesh.py``): one process per card, launched by
torchrun with ``--multihost``; ``--batch_size`` is per rank, so the global
batch is the number of ranks times it:

    torchrun --nproc_per_node 8 -m tedm_tpu_torch.train --multihost \
        --experiment img_only [--param_sharding fsdp] ...
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from tedm_tpu_torch.config import Config, config_from_args
from tedm_tpu_torch.parallel import mesh
from tedm_tpu_torch.utils.device import strict_fp32

DIFFUSION_EXPERIMENTS = ("img_only", "joint", "conditional", "joint_and_cond")
HEAD_EXPERIMENTS = ("LEDM", "LEDMe", "TEDM")

# (flag, is it set, the ROADMAP item that ports its feature): the mesh's
# axes other than 'data' (tensor parallel, spatial sharding) and the other
# input pipelines
NOT_PORTED = (
    ("--param_sharding", lambda c: c.param_sharding == "tp", "A.5h"),
    ("--shard_spatial", lambda c: c.shard_spatial, "A.5h"),
    ("--mesh_axes", lambda c: tuple(c.mesh_axes) != ("data",), "A.5h"),
    ("--data_backend", lambda c: c.data_backend != "threads", "A.5h"),
)


def dispatch(config: Config, device: Union[str, torch.device] = "cuda") -> None:
    from tedm_tpu_torch.trainers import baseline, contrastive, datasetdm, diffusion, per_step

    mains: Dict[str, Callable[..., None]] = {
        **{e: diffusion.main for e in DIFFUSION_EXPERIMENTS},
        **{e: datasetdm.main for e in HEAD_EXPERIMENTS},
        "baseline": baseline.main,
        "PDDM": per_step.main,
        "global_cl": contrastive.main_global,
        "local_cl": contrastive.main_local,
        "global_finetune": contrastive.main_finetune,
        "glob_loc_finetune": contrastive.main_finetune,
    }
    if config.experiment not in mains:
        raise ValueError(f"unknown experiment {config.experiment}")
    if config.grad_accum > 1 and config.experiment not in DIFFUSION_EXPERIMENTS:
        # the heads use BatchNorm, whose batch statistics over a microbatch
        # differ from those over the batch: accumulation would not be exact
        raise ValueError(
            f"--grad_accum is only supported for the diffusion experiments "
            f"({'/'.join(DIFFUSION_EXPERIMENTS)}), not {config.experiment!r}: its head "
            "uses BatchNorm, whose batch statistics are not microbatch-decomposable"
        )
    for flag, is_set, item in NOT_PORTED:
        if is_set(config):
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP item {item}")
    if config.multihost:
        device = mesh.init_multihost(device)
    mesh.make_mesh(tuple(config.mesh_shape), tuple(config.mesh_axes))
    print(f"Experiment folder: {config.log_dir}")
    mains[config.experiment](config, device)


def main(argv: Optional[Sequence[str]] = None, device: Union[str, torch.device] = "cuda") -> None:
    strict_fp32()
    dispatch(config_from_args(argv), device)


if __name__ == "__main__":
    main()
