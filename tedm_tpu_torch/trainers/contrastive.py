"""The contrastive arms: global_cl, local_cl and the two finetunes (port of
``tedm_tpu/trainers/contrastive.py``).

Reference: trainers/train_global_cl.py (SimCLR NT-Xent on CXR14),
trainers/train_local_cl.py (region-contrastive on the first 2 decoder
stages; only ``ups[:2]`` trains, even g2 stays at its random init,
train_local_cl.py:183-192), and trainers/finetune_glob_cl.py /
finetune_glob_loc_cl.py (supervised JSRT finetune of the pretrained UNet;
downs, init_conv and mid frozen until ``--unfreeze_weights_at_step``;
crop and brightness/contrast augmentation under ``--augment_at_finetuning``).

Pretraining computes in fp32 whatever ``--mixed_precision`` says, with plain
Adam at ``--lr`` even under ``--weight_decay``, as JAX's ``_train_cl`` does
(its models get no dtype, its optimizer is ``optax.adam``). Each step draws
two augmented views of the batch and, for LocalCL, the region centres from
a ``torch.Generator`` on the device seeded from ``config.seed``, or takes
them as arguments. LocalCL's frozen modules have ``requires_grad`` off, so
its backward runs through ``ups[:2]`` alone: without weight decay that gives
JAX's masked-gradient numbers. The CXR14 loaders drop their last partial
batch: a padding row would enter the losses as an image. A CL checkpoint
holds ``{"params", "opt_state", "step"}``, ``params`` the model's
state_dict (BatchNorm statistics included); its ``unet.*`` keys are what JAX's
CL model initialises, and a warm start copies exactly those
(``_deep_merge``): the rest keeps the fresh init.

The finetune is the baseline's task (``trainers/baseline.py``) warm-started
from ``--glob_loc_model_path`` for ``glob_loc_finetune`` when it is set,
else from ``--global_model_path``, trained by the shared loop
(``trainers/common.py``) with ``FROZEN_PREFIXES`` frozen before
``--unfreeze_weights_at_step`` (when it is above 0); its frozen parameters
get zero gradients, so its backward runs through the whole UNet. Its
checkpoint is the baseline's, ``{"unet"}``, which ``eval/harness.py`` and
``Predictor`` restore.

Under data parallelism (``parallel/mesh.py``) each rank draws the views of
its shard of the batch, and the losses take their negatives from the global
batch as JAX's program does: NT-Xent over every rank's features laid out
view 1 of every rank, then view 2; the region loss over every rank's patches
laid out (aug, region, global image), at rank 0's region centres.

Under ``--shard_spatial`` (``parallel/spatial.py``) the ranks of a spatial
group read the same rows and draw alike, so each builds both views from
the whole images, as JAX's step augments the whole sharded batch
(tedm_tpu/trainers/contrastive.py:91, a crop moves rows across the
shards), and only then keeps its rows of them for the UNet
(``spatial.local_rows``). The models hand back whole maps (gathered along
H), so the losses run as without the axis, over the data group; the loss
scale stays the data axis's size. The finetunes run the baseline's loop,
sharded as the baseline is.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Union

import numpy as np
import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.pipeline import build_dataloaders
from tedm_tpu_torch.models.contrastive import GlobalCL, LocalCL, global_nt_xent, region_centres, region_loss, region_rows
from tedm_tpu_torch.ops.augment import augment_and_concat, brightness_contrast, crop_batch
from tedm_tpu_torch.parallel import mesh, spatial
from tedm_tpu_torch.trainers import baseline
from tedm_tpu_torch.trainers.common import init_seeded, to_nchw, train_segmentation, unet_kernels
from tedm_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from tedm_tpu_torch.utils.device import resolve_device
from tedm_tpu_torch.utils.interrupt import graceful_shutdown
from tedm_tpu_torch.utils.logging import MetricsLogger

FROZEN_PREFIXES = ("downs", "init_conv", "mid_")  # reference: finetune_glob_cl.py:64-67


def build_model(config: Config, device: Union[str, torch.device] = "cuda") -> Union[GlobalCL, LocalCL]:
    """GlobalCL for ``global_cl``, else LocalCL, with torch's default init
    from ``config.seed``, in fp32, with the opt-in kernels of ``config``, on
    ``device``."""
    cls = GlobalCL if config.experiment == "global_cl" else LocalCL
    model = init_seeded(
        config.seed,
        lambda: cls(img_size=config.img_size, dim=config.dim, dim_mults=tuple(config.dim_mults),
                    channels=config.channels, **unet_kernels(config)),
    )
    return model.to(resolve_device(device))


def load_unet_subtree(path: str, device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
    """The ``unet`` state of a GlobalCL or LocalCL checkpoint, keys without
    the ``unet.`` prefix (``_load_unet_subtree``)."""
    state, _ = load_checkpoint(path, map_location=device, verbose=False)
    return {k[len("unet."):]: v for k, v in state["params"].items() if k.startswith("unet.")}


def warm_start(module: torch.nn.Module, path: str) -> None:
    """Copy the CL checkpoint's UNet into ``module`` as ``_deep_merge``
    does: every key it has, none of the others. A key that ``module`` lacks
    is an error."""
    sub = load_unet_subtree(path, next(module.parameters()).device)
    missing, unexpected = module.load_state_dict(sub, strict=False)
    if unexpected:
        raise KeyError(f"{path} holds keys the model has not: {unexpected[:5]}")


class CLSteps(NamedTuple):
    """``train_step(x, generator=None, views=None, centres=None) -> loss``
    updates the model in place (x the (B, C, H, W) batch; ``views`` its two
    augmented views, (2B, C, H, W), drawn from ``generator`` when not
    given; ``centres`` LocalCL's region centres); ``eval_step(x, generator)
    -> loss`` in eval mode. Losses come back as device scalars."""

    train_step: Callable[..., torch.Tensor]
    eval_step: Callable[..., torch.Tensor]


def make_steps(config: Config, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               forward: Optional[torch.nn.Module] = None, dp: Optional[mesh.DataParallel] = None) -> CLSteps:
    """The steps of ``model``, called through ``forward`` (its DDP or FSDP
    wrapper, ``dp``'s) when given. Every rank computes the global loss from
    the gathered features and back-propagates it whole: its own rows' part
    of the gradient, ``world`` times over, which DDP's mean over the ranks
    turns into the global gradient. Under ``dp``'s spatial plan each rank
    runs the model on its rows of the whole views (module docstring)."""
    forward = forward if forward is not None else model
    depth = len(model.unet.downs) - 1

    def plan_of(views):
        return None if dp is None else dp.rows_plan(views.shape[2], depth)

    def loss_of(views, generator, centres):
        feats = forward(spatial.local_rows(views))
        b, n = views.shape[0] // 2, mesh.data_world()
        if isinstance(model, GlobalCL):
            # (rank, view, row) -> (view, rank, row): JAX's layout of the global batch
            f = mesh.gather_rows(feats).reshape(n, 2, b, -1).transpose(0, 1).reshape(2 * n * b, -1)
            return global_nt_xent(f, n * b, config.tau)
        if centres is None:  # every rank draws them; rank 0's serve the global batch
            centres = tuple(mesh.broadcast(c) for c in region_centres(*feats.shape[2:], generator))
        rows = mesh.gather_rows(region_rows(feats, b, centres)[None])  # (rank, aug, region, row, D)
        return region_loss(rows.permute(1, 2, 0, 3, 4).reshape(-1, rows.shape[-1]), n * b, config.tau)

    def train_step(x, generator=None, views=None, centres=None):
        forward.train()
        if views is None:
            views = augment_and_concat(x, generator)
        with spatial.sharded(plan_of(views)):
            loss = loss_of(views, generator, centres)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if dp is not None:
            dp.finish_grads()
        optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(x, generator):
        # eval mode: BatchNorm's running statistics, none updated (the
        # reference's validate() calls model.eval(), train_local_cl.py)
        forward.eval()
        views = augment_and_concat(x, generator)
        with spatial.sharded(plan_of(views)):
            return loss_of(views, generator, None)

    return CLSteps(train_step, eval_step)


def trainable_parameters(model: torch.nn.Module):
    """GlobalCL: every parameter; LocalCL: ``unet.ups[:l]`` only
    (reference: train_local_cl.py:183-192). The others get
    ``requires_grad`` off."""
    if isinstance(model, LocalCL):
        model.requires_grad_(False)
        model.unet.ups.requires_grad_(True)
    return [p for p in model.parameters() if p.requires_grad]


def _train_cl(config: Config, model: torch.nn.Module, device: torch.device) -> None:
    """The CL loop (reference train/validate, train_global_cl.py:71-137):
    unlabelled CXR14 batches, two augmented views, the feature loss,
    best-val checkpoints; ``--resume_path``, ``--ckpt_every`` and a
    resumable checkpoint on SIGTERM/SIGINT as in the shared loop."""
    dp = mesh.data_parallel_setup(config, device)
    step, state = 0, None
    if config.resume_path and checkpoint_exists(config.resume_path):
        state, _ = load_checkpoint(config.resume_path, config, map_location=device)
        model.load_state_dict(state["params"])
        step = int(state["step"])
        print(f"Resumed from {config.resume_path} at step {step}")
    trainable_parameters(model)  # before the wrap: DDP reduces what takes gradients
    forward = dp.wrap(model)
    optimizer = torch.optim.Adam(dp.optimizer_params(p for p in model.parameters() if p.requires_grad), lr=config.lr)
    if state is not None:
        dp.load_optimizer_state(optimizer, state["opt_state"])
    steps = make_steps(config, model, optimizer, forward, dp)
    loaders = build_dataloaders(
        "CXR14", config.data_dir, config.img_size, config.batch_size, config.num_workers,
        seed=config.seed, synthetic=config.synthetic_data, splits_dir=config.splits_dir, drop_last=True,
        backend=config.data_backend, device=device, **mesh.loader_shard(),
    )
    logger = MetricsLogger(config.log_dir, config, enabled=not config.debug)

    generator = torch.Generator(device=device).manual_seed(mesh.rank_seed(config.seed))
    best_val = float("inf")
    train_losses = []
    t0, imgs = time.time(), 0

    def make_state():  # a collective under FSDP: every rank builds it, rank 0 writes it
        return {"params": dp.state_dict(model), "opt_state": dp.optimizer_state(optimizer), "step": step}

    with graceful_shutdown() as should_stop:
        for batch in loaders["train"].repeat():
            step += 1
            train_losses.append(steps.train_step(to_nchw(batch["image"], device), generator))
            imgs += len(batch["valid"])

            if step % config.log_freq == 0 or config.debug:
                # read the window's losses (waiting for its steps) before the clock
                window_loss = torch.stack(train_losses).mean().item()
                dt = time.time() - t0
                imgs = mesh.rows_seen(imgs)
                logger.log({"train/loss": window_loss, "train/imgs_per_sec": imgs / max(dt, 1e-9)}, step)
                train_losses, t0, imgs = [], time.time(), 0

            if step % config.val_freq == 0 or config.debug:
                vloss, n = 0.0, 0
                for i, vb in enumerate(loaders["val"]):
                    vloss += float(steps.eval_step(to_nchw(vb["image"], device), generator))
                    n += 1
                    if i + 1 == config.max_val_steps or config.debug:
                        break
                # the same on every rank (the loss of the gathered batch), reduced all the same
                vloss = mesh.host_sum([vloss / max(n, 1)])[0] / mesh.world()
                logger.log({"val/loss": vloss}, step)
                if vloss < best_val and not config.debug:
                    best_val = vloss
                    save_checkpoint(f"{config.log_dir}/best", make_state(), config)

            if config.ckpt_every and step % config.ckpt_every == 0:
                save_checkpoint(f"{config.log_dir}/step_{step}", make_state(), config)

            if mesh.host_any(should_stop()):
                save_checkpoint(f"{config.log_dir}/interrupted", make_state(), config)
                print(f"[interrupt] saved {config.log_dir}/interrupted at step {step}")
                break

            if step >= config.max_steps or config.debug:
                break
    logger.close()


def main_global(config: Config, device: Union[str, torch.device] = "cuda") -> None:
    dev = resolve_device(device)
    _train_cl(config, build_model(config, dev), dev)


def main_local(config: Config, device: Union[str, torch.device] = "cuda") -> None:
    """LocalCL, its encoder and mid warm-started from the GlobalCL
    checkpoint at ``--global_model_path`` when there is one (the decoder and
    g2 keep their init, as in the reference)."""
    dev = resolve_device(device)
    model = build_model(config, dev)
    if config.global_model_path and checkpoint_exists(config.global_model_path):
        warm_start(model.unet, config.global_model_path)
        print(f"Loaded GlobalCL backbone from {config.global_model_path}")
    _train_cl(config, model, dev)


def pretrained_path(config: Config) -> Optional[str]:
    """The CL checkpoint a finetune starts from (contrastive.py:341-345)."""
    if config.experiment == "glob_loc_finetune" and config.glob_loc_model_path:
        return config.glob_loc_model_path
    return config.global_model_path


def build_task(config: Config, device: Union[str, torch.device] = "cuda") -> baseline.BaselineTask:
    """The baseline's task (its UNet from ``config.seed``), warm-started from
    the CL checkpoint of ``pretrained_path`` when there is one."""
    task = baseline.build_task(config, device)
    path = pretrained_path(config)
    if path and checkpoint_exists(path):
        warm_start(task.unet, path)
        print(f"Loaded pretrained encoder from {path} "
              "(note: decoder values come from the CL init, as in the reference)")
    return task


def frozen_parameters(task: baseline.BaselineTask):
    """The parameters under ``FROZEN_PREFIXES``, frozen before
    ``--unfreeze_weights_at_step``."""
    return [p for n, p in task.unet.named_parameters() if n.startswith(FROZEN_PREFIXES)]


def main_finetune(config: Config, device: Union[str, torch.device] = "cuda") -> None:
    """global_finetune / glob_loc_finetune: the baseline UNet on JSRT,
    warm-started from the CL checkpoint (reference: finetune_glob_cl.py:117-171)."""
    task = build_task(config, device)
    loaders = build_dataloaders(
        "JSRT", config.data_dir, config.img_size, config.batch_size,
        config.num_workers, config.n_labelled_images, seed=config.seed,
        synthetic=config.synthetic_data, splits_dir=config.splits_dir, backend=config.data_backend, device=device,
        **mesh.loader_shard(),
    )
    if config.augment_at_finetuning:
        loaders = dict(loaders, train=AugmentedLoader(loaders["train"], mesh.rank_seed(config.seed)))
    frozen = frozen_parameters(task) if config.unfreeze_weights_at_step > 0 else ()
    logger = MetricsLogger(config.log_dir, config, enabled=not config.debug)
    train_segmentation(config, task, loaders, logger, frozen, config.unfreeze_weights_at_step)
    logger.close()


class AugmentedLoader:
    """A ``Loader`` whose batches get the same crop on image and mask, then
    brightness and contrast on the image (reference:
    finetune_glob_cl.py:30-34), on the host from a CPU generator seeded
    ``seed + 12345``; batches stay NHWC numpy. Other attributes are the
    loader's."""

    def __init__(self, loader, seed: int):
        self.loader = loader
        self.generator = torch.Generator().manual_seed(seed + 12345)

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        nhwc = lambda t: np.ascontiguousarray(t.permute(0, 2, 3, 1).numpy())
        for b in self.loader:
            img, mask = crop_batch(to_nchw(b["image"], "cpu"), to_nchw(b["mask"], "cpu"), generator=self.generator)
            img = brightness_contrast(img, self.generator)
            yield {**b, "image": nhwc(img), "mask": nhwc(mask)}

    def repeat(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield from self
