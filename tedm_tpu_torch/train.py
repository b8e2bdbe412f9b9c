"""Experiment dispatcher (port of ``tedm_tpu/train.py``; reference: train.py:15-56).

    python -m tedm_tpu_torch.train --experiment {img_only,joint,conditional,
        joint_and_cond,baseline,LEDM,LEDMe,TEDM,PDDM,global_cl,local_cl,
        global_finetune,glob_loc_finetune} [--synthetic_data |
        --data_dir DIR [--splits_dir DIR]] [...]

The flags are the JAX package's (``tedm_tpu_torch.config.build_parser``).
Training runs on the card; ``main(argv, device="cpu")`` runs the plain
PyTorch path on the CPU. The combinations JAX refuses raise JAX's error,
where JAX raises it.

Data parallel (``parallel/mesh.py``): one process per card, launched by
torchrun with ``--multihost``; ``--batch_size`` is per rank, so the global
batch is the number of data ranks times it:

    torchrun --nproc_per_node 8 -m tedm_tpu_torch.train --multihost \
        --experiment img_only [--param_sharding fsdp] ...

Tensor parallel over a ``model`` axis (``parallel/tensor_parallel.py``): D
data ranks times M model ranks, the ranks of one model group reading the
same rows:

    torchrun --nproc_per_node 8 -m tedm_tpu_torch.train --multihost \
        --mesh_shape 4 2 --mesh_axes data model --param_sharding tp \
        [--tp_min_width 256] --experiment img_only ...

Spatial parallel over a ``spatial`` axis (``parallel/spatial.py``; every
experiment): D data ranks times S spatial ranks, the ranks of one spatial
group reading the same rows, each holding its H / S rows of every map:

    torchrun --nproc_per_node 8 -m tedm_tpu_torch.train --multihost \
        --mesh_shape 4 2 --mesh_axes data spatial --shard_spatial \
        --experiment img_only ...

A mesh axis of any other name holds replicas (``parallel/mesh.py``).

``--data_backend device`` renders the synthetic images on the card
(``data/device_synthetic.py``, needs ``--synthetic_data``); ``grain`` reads
through grain (``data/grain_pipeline.py``) and raises where grain is not
installed.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from tedm_tpu_torch.config import Config, config_from_args
from tedm_tpu_torch.parallel import mesh
from tedm_tpu_torch.utils.device import strict_fp32

DIFFUSION_EXPERIMENTS = ("img_only", "joint", "conditional", "joint_and_cond")
HEAD_EXPERIMENTS = ("LEDM", "LEDMe", "TEDM")


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
    if config.multihost:
        device = mesh.init_multihost(device)
    mesh.check_config(config)  # after the group: JAX refuses spatial sharding on more than one device only
    mesh.make_mesh(tuple(config.mesh_shape), tuple(config.mesh_axes))
    print(f"Experiment folder: {config.log_dir}")
    mains[config.experiment](config, device)


def main(argv: Optional[Sequence[str]] = None, device: Union[str, torch.device] = "cuda") -> None:
    strict_fp32()
    dispatch(config_from_args(argv), device)


if __name__ == "__main__":
    main()
