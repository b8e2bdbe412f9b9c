"""DDPM backbone training (port of ``tedm_tpu/trainers/diffusion.py``).

Reference: trainers/train_CXR14.py (unconditional DDPM on CXR14) and
trainers/train_base_diffusion.py (the JSRT variants). One step: uniform t,
q_sample, UNet forward, L1 to the noise with p2 reweighting, backward
(every LinearAttention through the CUDA forward and backward kernels on the
card), one Adam step (AdamW under ``--weight_decay``), and the EMA of the
weights under ``--ema_decay``. ``--grad_accum N`` splits the batch into N
microbatches whose losses are weighted by their valid rows, so the loss and
gradients are exactly the global masked mean. Validation: the mean loss over
evenly spaced timesteps and a grid of samples from the full reverse
trajectory, with the EMA weights when they exist. Checkpoints hold
``{"params", "opt_state", "step"[, "ema_params"]}`` state_dicts;
``--resume_path`` restores them. ``--profile_dir`` traces steps 10 to 15
(``utils/profiling.py``).

t and the noise come from a ``torch.Generator`` on the device, seeded from
``config.seed``, or are given to the step.

Under data parallelism (``parallel/mesh.py``) the UNet is wrapped for DDP or
FSDP (the EMA sharded as its weights are), each rank reads its shard of the
train set and draws its own t and noise, and the loss is the masked mean
over the valid rows of every rank: each rank back-propagates ``world`` times
its share, weighted by its valid rows over the global count, microbatch by
microbatch under ``--grad_accum`` with the gradient reduction on the last
one only. The logged loss is the global one; the best-validation
checkpoint and a signal are decided on values reduced over the ranks, and
rank 0 writes. Under ``--shard_spatial`` (``parallel/spatial.py``) a step
and a validation batch run on this rank's rows of the images, the
condition and the noise (drawn whole, the ranks of a spatial group drawing
alike), each image's loss adding the ranks' sums over pixels; the samples
of the validation grid are drawn whole on every rank.
"""

from __future__ import annotations

import contextlib
import copy
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.data.pipeline import build_dataloaders
from tedm_tpu_torch.models.diffusion import (
    sample_loop_with_snapshots,
    train_loss,
    unnormalize_to_zero_to_one,
    val_loss,
)
from tedm_tpu_torch.models.unet import Unet
from tedm_tpu_torch.ops.schedules import DiffusionSchedule, make_schedule
from tedm_tpu_torch.parallel import mesh, spatial
from tedm_tpu_torch.trainers.common import compute_dtype, init_seeded, make_optimizer, to_nchw, unet_kernels
from tedm_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from tedm_tpu_torch.utils.device import resolve_device
from tedm_tpu_torch.utils.interrupt import graceful_shutdown
from tedm_tpu_torch.utils.logging import MetricsLogger
from tedm_tpu_torch.utils.profiling import StepTrace

CONDITIONAL = ("conditional", "joint_and_cond")


def mode_channels(config: Config) -> Tuple[int, int]:
    """(x_channels, model_input_channels) per experiment mode (reference:
    trainers/train_base_diffusion.py:26-32): img_only is unconditional on
    images; joint is a DDPM over cat(img, seg); conditional and
    joint_and_cond concatenate the condition to every model input."""
    if config.experiment == "joint":
        return 2, 2
    if config.experiment in CONDITIONAL:
        return 1, 2
    return config.channels, config.channels


def build_model(config: Config) -> Unet:
    """The UNet of ``config`` with torch's default init from ``config.seed``,
    computing in bf16 under ``--mixed_precision``, with the kernels its
    ``--no_pallas`` and ``--use_pallas_*`` flags choose, and block
    checkpointing under ``--remat`` (JAX passes ``remat`` in this trainer
    alone, tedm_tpu/trainers/diffusion.py:82)."""
    x_ch, in_ch = mode_channels(config)
    return init_seeded(
        config.seed,
        lambda: Unet(dim=config.dim, dim_mults=tuple(config.dim_mults), channels=x_ch,
                     in_channels=in_ch, dtype=compute_dtype(config), remat=config.remat,
                     **unet_kernels(config)),
    )


class Steps(NamedTuple):
    """``train_step(x, cond, valid, generator=None, t=None, noise=None) ->
    (loss, channel_losses)`` updates the model (and the EMA) in place;
    ``eval_step(model, x, cond, valid, generator) -> val loss``;
    ``sample_grid(model, cond, generator, n) -> (n, H, W*C, 1)`` numpy in
    [0, 1]. The losses come back as device tensors, unread."""

    train_step: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    eval_step: Callable[..., torch.Tensor]
    sample_grid: Callable[..., np.ndarray]


def make_steps(
    config: Config,
    unet: Unet,
    sched: DiffusionSchedule,
    optimizer: torch.optim.Optimizer,
    ema: Optional[Unet] = None,
    dp: Optional[mesh.DataParallel] = None,
) -> Steps:
    """``unet`` is the module to call (a DDP or FSDP one under ``dp``)."""
    conditional = config.experiment in CONDITIONAL
    depth = len(config.dim_mults) - 1

    def plan_of(x):
        return None if dp is None else dp.rows_plan(x.shape[2], depth)

    def cut(x, cond):
        """This rank's rows of ``x`` and of a conditional run's condition."""
        return spatial.local_rows(x), spatial.local_rows(cond) if conditional else cond
    x_ch, _ = mode_channels(config)
    # joint x has (img, seg) channels: the loss is also split per channel,
    # the reference's intended train_loss/img and train_loss/seg
    # (train_base_diffusion.py:58-62)
    split_channels = x_ch > 1
    ema_decay = float(config.ema_decay)
    accum = int(config.grad_accum)

    def apply_fn_of(model: Unet, cond: torch.Tensor):
        if not conditional:
            return model

        def apply(x, t):
            # val_loss folds timesteps into the batch: tile the condition
            return model(torch.cat([x, cond.repeat(x.shape[0] // cond.shape[0], 1, 1, 1)], dim=1), t)

        return apply

    def loss_of(x, cond, valid, t, noise, generator):
        out = train_loss(
            apply_fn_of(unet, cond), sched, x, t=t, noise=noise, generator=generator,
            objective=config.objective, normalize=config.normalize, valid=valid,
            aux_channel_losses=split_channels,
        )
        return out if split_channels else (out, torch.zeros(1, device=x.device))

    def train_step(x, cond, valid, generator=None, t=None, noise=None):
        with spatial.sharded(plan_of(x)):
            x, cond = cut(x, cond)
            return sharded_step(x, cond, valid, generator, t, None if noise is None else spatial.local_rows(noise))

    def sharded_step(x, cond, valid, generator, t, noise):
        optimizer.zero_grad(set_to_none=True)
        valid = valid.float()
        n = mesh.data_world()
        # microbatch i's loss is the masked mean over its own rows; weighted
        # by w_i = max(its valid count, 1) and divided by the global count
        # (every rank's rows) it adds up to the global masked mean, loss and
        # gradients alike (at one microbatch in one process, w_i = 1). Each
        # backward frees its microbatch's activations; the gradients are
        # reduced over the ranks in the last one.
        mb = x.shape[0] // accum
        denom = mesh.reduced(valid.sum()).clamp(min=1.0)
        loss, ch_losses = 0.0, 0.0
        for i in range(accum):
            rows = slice(i * mb, (i + 1) * mb)
            pick = lambda a: None if a is None else a[rows]
            with dp.no_sync(unet, sync=i == accum - 1) if dp is not None else contextlib.nullcontext():
                loss_i, ch_i = loss_of(
                    x[rows], cond[rows] if conditional else cond, valid[rows],
                    pick(t), pick(noise), generator,
                )
                w_i = valid[rows].sum().clamp(min=1.0) / denom
                (loss_i * (w_i * n)).backward()
            loss = loss + w_i * loss_i.detach()
            ch_losses = ch_losses + w_i * ch_i.detach()
        sums = mesh.reduced(torch.cat([loss.reshape(1), ch_losses.reshape(-1)]))
        loss, ch_losses = sums[0], sums[1:]
        if dp is not None:
            dp.finish_grads()
        optimizer.step()
        if ema is not None:
            with torch.no_grad():
                e, p = mesh.local_tensors(ema.parameters()), mesh.local_tensors(unet.parameters())
                torch._foreach_mul_(e, ema_decay)
                torch._foreach_add_(e, p, alpha=1.0 - ema_decay)
        return loss.detach(), ch_losses.detach()

    @torch.no_grad()
    def eval_step(model, x, cond, valid, generator):
        with spatial.sharded(plan_of(x)):
            x, cond = cut(x, cond)
            return val_loss(
                apply_fn_of(model, cond), sched, x, config.val_steps, generator=generator,
                objective=config.objective, normalize=config.normalize, valid=valid,
            )

    @torch.no_grad()
    def sample_grid(model, cond, generator, n):
        _, snaps = sample_loop_with_snapshots(
            apply_fn_of(model, cond), sched, (1, x_ch, config.img_size, config.img_size),
            generator, n_snapshots=n, objective=config.objective,
            dynamic_threshold_percentile=config.dynamic_threshold_percentile,
        )
        snaps = snaps[:, 0]  # (n, C, H, W); a joint sample's channels side by side
        snaps = torch.cat([snaps[:, c : c + 1] for c in range(snaps.shape[1])], dim=3)
        return unnormalize_to_zero_to_one(snaps.clamp(-1.0, 1.0)).permute(0, 2, 3, 1).cpu().numpy()

    return Steps(train_step, eval_step, sample_grid)


def _f32(a):
    return a.float() if torch.is_tensor(a) else a.astype(np.float32)


def batch_to_x_cond(config: Config, batch: Dict[str, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-mode (x_0, cond), NHWC numpy (NCHW tensors from the ``device``
    backend): img_only -> (image, dummy); joint -> (cat(image, mask),
    dummy); conditional -> (mask, image in [-1, 1]); joint_and_cond ->
    (image, mask in [-1, 1])."""
    img = batch["image"]
    dummy = np.zeros((1, 1, 1, 1), np.float32)
    if config.experiment == "joint":
        if torch.is_tensor(img):
            return torch.cat([img, batch["mask"]], dim=1), dummy
        return np.concatenate([img, batch["mask"]], axis=-1), dummy
    if config.experiment == "conditional":
        return batch["mask"], _f32(img) * 2.0 - 1.0
    if config.experiment == "joint_and_cond":
        return img, _f32(batch["mask"]) * 2.0 - 1.0
    return img, dummy


def validate(
    config: Config, steps: Steps, model: Unet, loader, generator: torch.Generator,
    logger: MetricsLogger, step: int,
) -> float:
    """The val loss weighted by valid rows, over up to ``max_val_steps``
    batches, and a logged grid of ``min(n_sampled_imgs, 10)`` snapshots of
    one sampled trajectory."""
    dev = generator.device
    losses, weights = [], []
    cond0 = None
    for i, batch in enumerate(loader):
        x, cond = batch_to_x_cond(config, batch)
        w = float(batch["valid"].sum())
        if w == 0:
            continue
        if cond0 is None:
            cond0 = to_nchw(cond[:1], dev)
        valid = torch.from_numpy(batch["valid"]).to(dev)
        losses.append(float(steps.eval_step(model, to_nchw(x, dev), to_nchw(cond, dev), valid, generator)) * w)
        weights.append(w)
        if i + 1 == config.max_val_steps or config.debug:
            break
    logger.log_images("val/samples", steps.sample_grid(model, cond0, generator, min(config.n_sampled_imgs, 10)), step)
    # every rank read the same (unsharded) batches with its own noise: the
    # mean over the ranks, the same on each, decides the checkpoint
    return mesh.host_sum([float(np.sum(losses) / max(np.sum(weights), 1e-9))])[0] / mesh.world()


def main(config: Config, device: Union[str, torch.device] = "cuda") -> None:
    dev = resolve_device(device)
    dp = mesh.data_parallel_setup(config, dev)
    unet = build_model(config).to(dev)
    sched = make_schedule(
        config.timesteps, config.beta_schedule, config.p2_loss_weight_gamma, config.p2_loss_weight_k,
    ).to(dev)
    step, state = 0, None
    ema_state = None
    if config.resume_path and checkpoint_exists(config.resume_path):
        state, _ = load_checkpoint(config.resume_path, config, map_location=dev)
        unet.load_state_dict(state["params"])
        step = int(state["step"])
        ema_state = state.get("ema_params")
        print(f"Resumed from {config.resume_path} at step {step}")
    use_ema = config.ema_decay > 0.0
    ema = None
    if use_ema:
        # the average starts at the live weights, or where a resumed run left it
        ema = copy.deepcopy(unet).requires_grad_(False)
        if ema_state is not None:
            ema.load_state_dict(ema_state)
        dp.place(ema)  # sharded as the weights it follows (FSDP, TP)
    model = dp.wrap(unet)
    # --weight_decay as the supervised loop honours it; the reference
    # diffusion trainer is plain Adam, the default
    optimizer = make_optimizer(config, dp.optimizer_params(unet.parameters()))
    if state is not None:
        dp.load_optimizer_state(optimizer, state["opt_state"])

    # the JSRT modes need masks (reference: train_base_diffusion.py:26-32)
    loaders = build_dataloaders(
        "CXR14" if config.experiment == "img_only" else "JSRT", config.data_dir, config.img_size, config.batch_size, config.num_workers,
        seed=config.seed, synthetic=config.synthetic_data, splits_dir=config.splits_dir, backend=config.data_backend,
        device=dev, **mesh.loader_shard(),
    )
    logger = MetricsLogger(config.log_dir, config, enabled=not config.debug)
    steps = make_steps(config, model, sched, optimizer, ema, dp)
    generator = torch.Generator(device=dev).manual_seed(mesh.rank_seed(config.seed))

    def full_state() -> Dict[str, Any]:  # a collective under FSDP: every rank builds it, rank 0 writes it
        state = {"params": dp.state_dict(unet), "opt_state": dp.optimizer_state(optimizer), "step": step}
        if use_ema:
            state["ema_params"] = dp.state_dict(ema)
        return state

    best_val_loss = float("inf")
    train_losses, channel_losses = [], []
    t0, imgs = time.time(), 0
    with graceful_shutdown() as should_stop, StepTrace(config.profile_dir, dev) as tracer:
        for batch in loaders["train"].repeat():
            step += 1
            tracer.before(step)
            x, cond = batch_to_x_cond(config, batch)
            loss, ch_losses = steps.train_step(
                to_nchw(x, dev), to_nchw(cond, dev), torch.from_numpy(batch["valid"]).to(dev),
                generator=generator,
            )
            tracer.after(step)
            # device scalars: reading them here would wait for the card every step
            train_losses.append(loss)
            if config.experiment == "joint":
                channel_losses.append(ch_losses)
            imgs += int(batch["valid"].sum())

            if step % config.log_freq == 0 or config.debug:
                # read the window's losses (waiting for its steps) before the clock
                window_loss = torch.stack(train_losses).mean().item()
                dt = time.time() - t0
                imgs = mesh.rows_seen(imgs)
                metrics = {"train/loss": window_loss, "train/imgs_per_sec": imgs / max(dt, 1e-9)}
                if channel_losses:
                    ch = torch.stack(channel_losses).mean(dim=0).tolist()
                    metrics["train_loss/img"], metrics["train_loss/seg"] = ch[0], ch[1]
                    channel_losses = []
                logger.log(metrics, step)
                train_losses, t0, imgs = [], time.time(), 0

            if step % config.val_freq == 0 or config.debug:
                # the EMA weights, when kept, are the ones downstream loaders serve
                vloss = validate(config, steps, ema if use_ema else model, loaders["val"],
                                 generator, logger, step)
                logger.log({"val/loss": vloss}, step)
                if vloss < best_val_loss and not config.debug:
                    best_val_loss = vloss
                    save_checkpoint(f"{config.log_dir}/best", full_state(), config)

            if config.ckpt_every and step % config.ckpt_every == 0:
                save_checkpoint(f"{config.log_dir}/step_{step}", full_state(), config)

            if mesh.host_any(should_stop()):
                save_checkpoint(f"{config.log_dir}/interrupted", full_state(), config)
                print(f"[interrupt] saved {config.log_dir}/interrupted at step {step}")
                break

            if step >= config.max_steps or config.debug:
                break
    logger.close()
