"""The shared supervised segmentation loop (port of
``tedm_tpu/trainers/common.py``).

Reference behaviour (trainers/train_baseline.py:17-161): epochs until
max_steps; per-pixel BCE with logits reduced per image, then the mean;
labels repeated S times for a head whose logits fold S timesteps (TEDM);
the mean train loss logged every log_freq steps, per fold as well;
validation every val_freq steps with loss, Dice, precision and recall
(sigmoid > 0.5, nanmean over images); best-val checkpoints; optional early
stop at 1.5 times the best val loss; ``debug`` runs one step of everything.
Padding rows of the static-shape batches are masked out of every mean and
come out of the metrics as NaN. ``--profile_dir`` traces steps 10 to 15
(``utils/profiling.py``), as the JAX loop does.

A task names what the loop trains (``tedm_tpu/trainers/common.py``'s
``SegTask``): ``apply(x, generator=None, noise=None)`` maps an image batch to
logits, ``fold`` * B rows of them, step-major; ``t_steps`` names the folded
timesteps; ``modules`` maps a checkpoint key to each module whose
state_dict the checkpoint holds; ``trained`` is the one of them the optimizer
updates, in train mode for a step and in eval mode for validation. The
diffusion-feature heads (``trainers/datasetdm.py``, ``trainers/per_step.py``)
train their head on a frozen backbone, under ``torch.no_grad``; the baseline
(``trainers/baseline.py``) trains the whole UNet. One step is a forward and
backward and one Adam (AdamW under ``--weight_decay``) step. Feature noise
comes from a ``torch.Generator`` on the device, seeded from ``config.seed``,
or is given.

``frozen`` and ``unfreeze_at`` are the JAX package's ``freeze_mask`` (the
contrastive finetune's, tedm_tpu/trainers/common.py:66-99): until step
``unfreeze_at`` (steps count from 1) those parameters' gradients are zeroed,
not dropped, and the optimizer's step leaves them as they were. optax counts
Adam's steps globally and JAX zeroes the frozen gradients, so the frozen
moments stay 0 while the count runs on, and the first step after the
unfreeze is bias-corrected by the global count; with zero gradients torch's
per-parameter ``step`` runs in lockstep (a gradient of ``None`` would stop
it, and the first step after the unfreeze would come out 0.64 to about 3
times JAX's). JAX also masks the update, since AdamW's decoupled decay
would shrink a frozen parameter: here the frozen parameters are put back
after the step.

Under data parallelism (``parallel/mesh.py``) ``trained`` is wrapped for DDP
or FSDP, each rank reads its shard of the train set and draws its own
noise, and the loss is the masked mean over the valid rows of every rank
(``mesh.global_share``): its share on each rank, the global value in the
logs. Under ``--param_sharding tp`` every module of the task is sharded by
the ``tp`` rule over the model group, the frozen backbone too, as JAX puts
a head's ``batch_stats`` (where its backbone rides) through the rule
(tedm_tpu/trainers/common.py:216-219); the ranks of one model group read
the same rows and draw alike. The best-validation checkpoint, the early
stop and a signal are decided on values reduced over the ranks; rank 0
writes. Under ``--shard_spatial`` (``parallel/spatial.py``) each step and
each validation batch runs on this rank's rows of the images, masks and
noise, the ranks of a spatial group reading the same rows and drawing
alike; a per-image mean over pixels adds the ranks' sums
(``masked_bce_per_image``, the metrics' counts) before the masked mean over
the valid rows, the same on every rank of the group.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.ops import metrics as M
from tedm_tpu_torch.parallel import mesh, spatial
from tedm_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from tedm_tpu_torch.utils.interrupt import graceful_shutdown
from tedm_tpu_torch.utils.logging import MetricsLogger
from tedm_tpu_torch.utils.profiling import StepTrace


def init_seeded(seed: int, build: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """Build modules with torch's default init from ``seed``, leaving the
    caller's global RNG state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def compute_dtype(config: Config) -> torch.dtype:
    """The UNet's compute dtype: bf16 under ``--mixed_precision``, as the JAX
    trainers pick it (tedm_tpu/trainers/datasetdm.py:40,
    tedm_tpu/trainers/diffusion.py:63). The parameters, Adam's moments and
    the checkpoints stay fp32; no loss scaling, as in JAX."""
    return torch.bfloat16 if config.mixed_precision else torch.float32


def unet_kernels(config: Config) -> Dict[str, bool]:
    """The ``Unet`` arguments of the kernel flags, as every JAX trainer
    passes ``config.use_pallas`` (off under ``--no_pallas``) and
    ``config.use_pallas_{groupnorm,resblock,flash}`` to its ``Unet``
    (tedm_tpu/trainers/diffusion.py:71-80,
    tedm_tpu/trainers/datasetdm.py:46-55,94-103)."""
    return dict(fused_groupnorm=config.use_pallas_groupnorm, fused_resblock=config.use_pallas_resblock,
                flash_attention=config.use_pallas_flash, use_pallas=config.use_pallas)


def to_nchw(a: Union[np.ndarray, torch.Tensor], device: Union[str, torch.device]) -> torch.Tensor:
    """An NHWC numpy batch as a contiguous NCHW float32 tensor on ``device``;
    a tensor (the ``device`` backend's batches, NCHW already) as a
    contiguous NCHW float32 tensor there. The layout is made with NCHW's own
    strides: at C = 1 a transposed NHWC array keeps a channel stride of 1,
    which torch reads as channels-last, so cuDNN would run every
    convolution channels-last and the kernels, which take NCHW activations,
    would refuse the input."""
    if torch.is_tensor(a):
        return a.to(device, torch.float32).contiguous(memory_format=torch.contiguous_format)
    x = torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)
    return x.clone(memory_format=torch.contiguous_format).to(device)


def make_optimizer(config: Config, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """Adam at ``config.lr``, AdamW under ``--weight_decay`` (optax.adam /
    optax.adamw in the JAX package: the same eps placement, and decay of
    the old parameter)."""
    if config.weight_decay:
        return torch.optim.AdamW(params, lr=config.lr, weight_decay=config.weight_decay)
    return torch.optim.Adam(params, lr=config.lr)


def masked_bce_per_image(
    logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image BCE (mean over pixels and channels) and its mean over the
    valid rows: reduce('b c h w -> b c', 'mean').mean() without padding.
    Under a spatial plan the mean over the whole image from this rank's
    rows (``spatial.mean``)."""
    per_px = M.bce_with_logits(logits.float(), labels.float())
    per_img = spatial.mean(per_px.reshape(per_px.shape[0], -1), 1)
    return per_img, (per_img * valid).sum() / valid.sum().clamp(min=1.0)


def _fold(task, y: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels and valid mask repeated to the folded logits, step-major."""
    if task.fold > 1:
        return y.repeat(task.fold, 1, 1, 1), valid.repeat(task.fold)
    return y, valid


def rows_plan(dp: Optional[mesh.DataParallel], task, height: int) -> Optional[spatial.Plan]:
    """The spatial plan of a batch of ``height`` rows through ``task``'s UNet
    (``DataParallel.rows_plan``), None without ``--shard_spatial``."""
    if dp is None or dp.spatial is None:
        return None
    unet = getattr(task.unet, "module", task.unet)  # the baseline's is the DDP-wrapped one
    return dp.rows_plan(height, len(unet.downs) - 1)


def make_train_step(task, optimizer: torch.optim.Optimizer, frozen: Sequence[torch.nn.Parameter] = (),
                    dp: Optional[mesh.DataParallel] = None):
    """One training step of ``task``'s trained module: ``step(x, y, valid,
    generator=None, noise=None, freeze=False) -> (loss, per_fold)``, device
    scalars; the noise is as in ``SegTask.apply``. ``per_fold`` is the masked
    mean loss of each folded timestep (TEDM per-timestep logging, reference:
    train_baseline.py:56-58,70-73). With ``freeze`` the ``frozen`` parameters
    get zero gradients and keep their values (module docstring). Each rank
    back-propagates ``world`` times its share of the global masked mean,
    which DDP's mean over the ranks turns into the global gradient (in one
    process: the masked mean itself; ``world`` is the data axis's size), and
    both values come back global;
    ``dp`` reduces the gradients FSDP leaves to it and, under
    ``--shard_spatial``, gives the plan under which the step runs on this
    rank's rows of ``x``, ``y`` and ``noise`` (whole maps)."""
    frozen = list(frozen)

    def step(x, y, valid, generator=None, noise=None, freeze=False):
        task.trained.train()
        with spatial.sharded(rows_plan(dp, task, x.shape[2])):
            x, y = spatial.local_rows(x), spatial.local_rows(y)
            logits = task.apply(x, generator=generator, noise=None if noise is None else spatial.local_rows(noise))
            y_f, valid_f = _fold(task, y, valid)
            per_img, _ = masked_bce_per_image(logits, y_f, valid_f)
            loss = mesh.global_share(per_img, valid_f)
            optimizer.zero_grad(set_to_none=True)
            (loss * mesh.data_world()).backward()
        if dp is not None:
            dp.finish_grads()
        if freeze and frozen:
            with torch.no_grad():
                held = [p for p in frozen if p.grad is not None]
                torch._foreach_zero_(mesh.local_tensors(p.grad for p in held))
                kept = [mesh.local(p).detach().clone() for p in held]
            optimizer.step()
            with torch.no_grad():
                torch._foreach_copy_([mesh.local(p).detach() for p in held], kept)
        else:
            optimizer.step()
        w = valid.float()
        per_fold = (per_img.detach().reshape(task.fold, -1) * w).sum(dim=1)
        sums = mesh.reduced(torch.cat([loss.detach()[None], per_fold, w.sum()[None]]))
        return sums[0], sums[1:-1] / sums[-1].clamp(min=1.0)

    return step


def make_eval_step(task, dp: Optional[mesh.DataParallel] = None):
    """``step(x, y, valid, generator) -> (loss, dice, precision, recall)``
    of one batch in eval mode; the metrics are (fold*B, C) with NaN on
    padding rows. Under ``--shard_spatial`` on this rank's rows, the
    metrics' counts added over the row shards."""

    @torch.no_grad()
    def step(x, y, valid, generator):
        task.trained.eval()
        with spatial.sharded(rows_plan(dp, task, x.shape[2])):
            logits = task.apply(spatial.local_rows(x), generator=generator)
            y, valid = _fold(task, spatial.local_rows(y), valid)
            _, loss = masked_bce_per_image(logits, y, valid)
            y_hat = torch.sigmoid(logits.float()) > 0.5
            vmask = torch.where(valid > 0, 1.0, float("nan"))[:, None]
            total = spatial.spatial_sum
            return (loss, M.dice(y_hat, y, total) * vmask, M.precision(y_hat, y, total) * vmask,
                    M.recall(y_hat, y, total) * vmask)

    return step


def validate(config: Config, task, loader, generator: torch.Generator,
             dp: Optional[mesh.DataParallel] = None) -> Dict[str, float]:
    """Reference validate (trainers/train_baseline.py:99-144): the loss
    weighted by valid rows, the metrics by nanmean over images."""
    dev = next(task.trained.parameters()).device
    eval_step = make_eval_step(task, dp)
    losses, weights, dices, precs, recs = [], [], [], [], []
    for i, batch in enumerate(loader):
        loss, d, p, r = eval_step(
            to_nchw(batch["image"], dev), to_nchw(batch["mask"], dev),
            torch.from_numpy(batch["valid"]).to(dev), generator,
        )
        w = float(batch["valid"].sum())
        losses.append(float(loss) * w)
        weights.append(w)
        dices.append(d.cpu().numpy())
        precs.append(p.cpu().numpy())
        recs.append(r.cpu().numpy())
        if i + 1 == config.max_val_steps or config.debug:
            break
    val = {
        "val/loss": float(np.sum(losses) / max(np.sum(weights), 1e-9)),
        "val/dice": float(np.nanmean(np.concatenate(dices))),
        "val/precision": float(np.nanmean(np.concatenate(precs))),
        "val/recall": float(np.nanmean(np.concatenate(recs))),
    }
    # every rank read the same (unsharded) batches with its own noise: the
    # mean over the ranks, the same on each, decides the checkpoint
    return dict(zip(val, (v / mesh.world() for v in mesh.host_sum(list(val.values())))))


def train_segmentation(
    config: Config,
    task,
    loaders: Dict[str, Any],
    logger: MetricsLogger,
    frozen: Sequence[torch.nn.Parameter] = (),
    unfreeze_at: int = 0,
) -> None:
    """The shared loop over ``task`` on its trained module's device.
    Checkpoints hold the state_dict of each of ``task.modules`` under its key
    (a head's ``{"backbone", "classifier"}``, the baseline's ``{"unet"}``),
    ``opt_state`` and ``step``; ``--resume_path`` restores them. The
    ``frozen`` parameters stay as they are in the steps before
    ``unfreeze_at`` (module docstring)."""
    dev = next(task.trained.parameters()).device
    dp = mesh.data_parallel_setup(config, dev)
    step, state = 0, None
    if config.resume_path and checkpoint_exists(config.resume_path):
        state, _ = load_checkpoint(config.resume_path, config, map_location=dev)
        for name, module in task.modules.items():
            module.load_state_dict(state[name])
        step = int(state["step"])
        print(f"Resumed from {config.resume_path} at step {step}")
    # the trained module wrapped for DDP or FSDP; FSDP replaces its
    # parameters, so the frozen ones are found again by name
    names = {id(p): n for n, p in task.trained.named_parameters()}
    frozen_names = [names[id(p)] for p in frozen]
    raw = task.trained
    if dp.mode == "tp":  # a head's frozen backbone goes through the rule too
        for module in task.modules.values():
            if module is not raw:
                dp.place(module)
    task = dataclasses.replace(task, **{task.TRAINED: dp.wrap(raw, find_unused=True)})
    params = dict(raw.named_parameters())
    optimizer = make_optimizer(config, dp.optimizer_params(task.trained.parameters()))
    if state is not None:
        dp.load_optimizer_state(optimizer, state["opt_state"])
    train_step = make_train_step(task, optimizer, [params[n] for n in frozen_names], dp)

    generator = torch.Generator(device=dev).manual_seed(mesh.rank_seed(config.seed))
    best_val_loss = float("inf")
    train_losses: List[torch.Tensor] = []
    fold_losses: List[torch.Tensor] = []
    t0, imgs_seen = time.time(), 0

    def make_state():  # a collective under FSDP: every rank builds it, rank 0 writes it
        return {**{name: dp.state_dict(m) for name, m in task.modules.items()},
                "opt_state": dp.optimizer_state(optimizer), "step": step}

    with graceful_shutdown() as should_stop, StepTrace(config.profile_dir, dev) as tracer:
        for batch in loaders["train"].repeat():
            step += 1
            tracer.before(step)
            loss, per_fold = train_step(
                to_nchw(batch["image"], dev), to_nchw(batch["mask"], dev),
                torch.from_numpy(batch["valid"]).to(dev), generator=generator, freeze=step < unfreeze_at,
            )
            tracer.after(step)
            # device scalars: reading them here would wait for the card every step
            train_losses.append(loss)
            fold_losses.append(per_fold)
            imgs_seen += int(batch["valid"].sum())

            if step % config.log_freq == 0 or config.debug:
                # read the window's losses (waiting for its steps) before the clock
                window_loss = torch.stack(train_losses).mean().item()
                dt = time.time() - t0
                imgs_seen = mesh.rows_seen(imgs_seen)
                logs = {"train/loss": window_loss, "train/imgs_per_sec": imgs_seen / max(dt, 1e-9)}
                if task.fold > 1:
                    mean_fold = torch.stack(fold_losses).mean(dim=0).tolist()
                    for name, v in zip(task.t_steps, mean_fold):
                        logs[f"train_loss/step_{name}"] = v
                logger.log(logs, step)
                train_losses, fold_losses = [], []
                t0, imgs_seen = time.time(), 0

            if step % config.val_freq == 0 or config.debug:
                val = validate(config, task, loaders["val"], generator, dp)
                logger.log(val, step)
                if val["val/loss"] < best_val_loss and not config.debug:
                    best_val_loss = val["val/loss"]
                    save_checkpoint(f"{config.log_dir}/best", make_state(), config)
                elif val["val/loss"] > best_val_loss * 1.5 and config.early_stop:
                    return

            if config.ckpt_every and step % config.ckpt_every == 0:
                save_checkpoint(f"{config.log_dir}/step_{step}", make_state(), config)

            if mesh.host_any(should_stop()):
                save_checkpoint(f"{config.log_dir}/interrupted", make_state(), config)
                print(f"[interrupt] saved {config.log_dir}/interrupted at step {step}")
                return

            if step >= config.max_steps or config.debug:
                return
