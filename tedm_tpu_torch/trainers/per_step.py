"""PDDM: a linear probe over the diffusion features of each timestep (port
of ``tedm_tpu/trainers/per_step.py``; reference:
trainers/datasetDM_per_step.py).

One 1x1 conv over the S*960 feature channels of a frozen backbone, trained
by the shared loop; the paper's per-timestep analysis (the Step_1,
Step_10, ... experiment directories) runs it at one timestep each. Under
``--standardize_features`` the probe standardises its input by per-channel
moments over (batch, space) of the train set, padding rows left out, from a
pre-pass over the train loader whose noise comes from a generator seeded
from ``config.seed`` (each rank's own under data parallelism, over its
shard, the sums then added over the ranks: the moments of the whole set,
as one process takes them; under ``--shard_spatial`` each rank of a spatial
group over its rows, the sums added over the data x spatial ranks). (The reference computes per-(channel, pixel) moments
and then applies the probe to the raw features, :30-31, :104-113; without
the flag the port, as the JAX package, applies it to the raw features too.)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.pipeline import build_dataloaders
from tedm_tpu_torch.models.segmentation import LinearProbe, extract_features, masked_feature_sums
from tedm_tpu_torch.parallel import mesh, spatial
from tedm_tpu_torch.trainers.common import init_seeded, to_nchw, train_segmentation
from tedm_tpu_torch.trainers.datasetdm import SegTask, load_backbone
from tedm_tpu_torch.utils.device import resolve_device
from tedm_tpu_torch.utils.logging import MetricsLogger


def build_task(
    config: Config,
    device: Union[str, torch.device] = "cuda",
    loaders: Optional[Dict[str, Any]] = None,
    compute_stats: bool = True,
) -> SegTask:
    """The frozen backbone and a probe initialised from ``config.seed``, on
    ``device``. With ``--standardize_features`` and ``compute_stats`` the
    probe's ``mean`` and ``std`` come from a pre-pass over
    ``loaders["train"]``; ``compute_stats=False`` leaves them at 0 and 1 for
    a checkpoint to overwrite (evaluation and serving)."""
    dev = resolve_device(device)
    unet, sched = load_backbone(config, dev)
    t_steps = tuple(config.t_steps_to_save)
    n_steps = len(t_steps)
    probe = init_seeded(
        config.seed + 1,
        lambda: LinearProbe(
            stage_channels=tuple(config.dim * m for m in reversed(config.dim_mults)),
            n_steps=n_steps, out_channels=config.out_channels, img_size=config.img_size,
            standardize=config.standardize_features,
        ),
    ).to(dev).eval()
    task = SegTask(unet=unet, classifier=probe, sched=sched, t_steps=t_steps,
                   normalize=config.normalize and not config.extract_unnormalized)
    if config.standardize_features and compute_stats:
        generator = torch.Generator(device=dev).manual_seed(mesh.rank_seed(config.seed))
        plan = mesh.spatial_plan() if config.shard_spatial else None
        acc = None
        with torch.no_grad():
            for batch in loaders["train"]:
                x = to_nchw(batch["image"], dev)
                with spatial.sharded(spatial.plan_for(plan, x.shape[2], len(unet.downs) - 1)):
                    feats = extract_features(unet, sched, spatial.local_rows(x), t_steps,
                                             generator=generator, normalize=task.normalize)
                    sums = masked_feature_sums(feats, n_steps, torch.from_numpy(batch["valid"]).to(dev))
                acc = sums if acc is None else tuple(a + b for a, b in zip(acc, sums))
            total, squares, count = (mesh.reduced_pixels(a) for a in acc)
            mean = total / count
            probe.mean.copy_(mean)
            probe.std.copy_((squares / count - mean * mean).clamp(min=0.0).sqrt() + 1e-6)
    return task


def main(config: Config, device: Union[str, torch.device] = "cuda") -> None:
    """Train a PDDM probe on JSRT; checkpoints under ``config.log_dir``."""
    loaders = build_dataloaders(
        "JSRT", config.data_dir, config.img_size, config.batch_size,
        config.num_workers, config.n_labelled_images, seed=config.seed,
        synthetic=config.synthetic_data, splits_dir=config.splits_dir,
        backend=config.data_backend, device=device, **mesh.loader_shard(),
    )
    task = build_task(config, device, loaders)
    logger = MetricsLogger(config.log_dir, config, enabled=not config.debug)
    train_segmentation(config, task, loaders, logger)
    logger.close()
