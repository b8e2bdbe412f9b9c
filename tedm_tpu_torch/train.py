"""Experiment dispatcher (port of ``tedm_tpu/train.py``; reference: train.py:15-56).

    python -m tedm_tpu_torch.train --experiment {img_only,joint,conditional,
        joint_and_cond,LEDM,LEDMe,TEDM} --synthetic_data [...]

The flags are the JAX package's (``tedm_tpu_torch.config.build_parser``).
Training runs on the card; ``main(argv, device="cpu")`` runs the plain
PyTorch path on the CPU. The experiments and flags whose features the port
does not have yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Union

import torch

from tedm_tpu_torch.config import Config, config_from_args

DIFFUSION_EXPERIMENTS = ("img_only", "joint", "conditional", "joint_and_cond")
HEAD_EXPERIMENTS = ("LEDM", "LEDMe", "TEDM")

# (flag, is it set, the ROADMAP item that ports its feature)
NOT_PORTED = (
    ("--remat", lambda c: c.remat, "A.5"),
    ("--profile_dir", lambda c: c.profile_dir is not None, "A.5"),
    ("--multihost", lambda c: c.multihost, "A.5"),
    ("--mesh_shape", lambda c: bool(c.mesh_shape), "A.5"),
    ("--param_sharding", lambda c: c.param_sharding != "replicated", "A.5"),
    ("--shard_spatial", lambda c: c.shard_spatial, "A.5"),
    ("--data_backend", lambda c: c.data_backend != "threads", "A.5"),
)


def dispatch(config: Config, device: Union[str, torch.device] = "cuda") -> None:
    from tedm_tpu_torch.trainers import datasetdm, diffusion

    mains: Dict[str, Callable[..., None]] = {
        **{e: diffusion.main for e in DIFFUSION_EXPERIMENTS},
        **{e: datasetdm.main for e in HEAD_EXPERIMENTS},
    }
    if config.experiment not in mains:
        raise NotImplementedError(
            f"experiment {config.experiment!r} is not ported yet: the baseline, PDDM "
            "and contrastive trainers are ROADMAP item A.5"
        )
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
    print(f"Experiment folder: {config.log_dir}")
    mains[config.experiment](config, device)


def main(argv: Optional[Sequence[str]] = None, device: Union[str, torch.device] = "cuda") -> None:
    # fp32 means fp32: no TF32 in cuDNN convolutions (on by default) or in
    # matrix products, as the tolerances against the JAX package assume; and
    # a bf16 product sums in fp32, with no bf16 split-K reduction (on by
    # default), as JAX's preferred_element_type=float32 does
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dispatch(config_from_args(argv), device)


if __name__ == "__main__":
    main()
