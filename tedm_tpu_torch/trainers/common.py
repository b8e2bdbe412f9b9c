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
come out of the metrics as NaN.

One step is a forward and backward of the head, the backbone frozen under
``torch.no_grad``, and one Adam (AdamW under ``--weight_decay``) step. Its
feature noise comes from a ``torch.Generator`` on the device, seeded from
``config.seed``, or is given. ``freeze_mask`` of the JAX package serves
only the contrastive finetune (ROADMAP A.5) and is not ported.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, List, Tuple

import numpy as np
import torch

from tedm_tpu_torch.config import Config
from tedm_tpu_torch.ops import metrics as M
from tedm_tpu_torch.utils.checkpoint import checkpoint_exists, load_checkpoint, save_checkpoint
from tedm_tpu_torch.utils.interrupt import graceful_shutdown
from tedm_tpu_torch.utils.logging import MetricsLogger


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
    """The ``Unet`` arguments of the opt-in kernel flags, as every JAX
    trainer passes ``config.use_pallas_{groupnorm,resblock,flash}`` to its
    ``Unet`` (tedm_tpu/trainers/diffusion.py:71-80,
    tedm_tpu/trainers/datasetdm.py:46-55,94-103)."""
    return dict(fused_groupnorm=config.use_pallas_groupnorm, fused_resblock=config.use_pallas_resblock,
                flash_attention=config.use_pallas_flash)


def to_nchw(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An NHWC numpy batch as a contiguous NCHW float32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 3, 1, 2))).to(device)


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
    valid rows: reduce('b c h w -> b c', 'mean').mean() without padding."""
    per_px = M.bce_with_logits(logits.float(), labels.float())
    per_img = per_px.reshape(per_px.shape[0], -1).mean(dim=1)
    return per_img, (per_img * valid).sum() / valid.sum().clamp(min=1.0)


def _fold(task, y: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels and valid mask repeated to the folded logits, step-major."""
    if task.fold > 1:
        return y.repeat(task.fold, 1, 1, 1), valid.repeat(task.fold)
    return y, valid


def make_train_step(task, optimizer: torch.optim.Optimizer):
    """One training step of ``task``'s head: ``step(x, y, valid,
    generator=None, noise=None) -> (loss, per_fold)``, device scalars; the
    noise is as in ``SegTask.apply``. ``per_fold`` is the masked mean loss
    of each folded timestep (TEDM per-timestep logging, reference:
    train_baseline.py:56-58,70-73)."""

    def step(x, y, valid, generator=None, noise=None):
        task.classifier.train()
        logits = task.apply(x, generator=generator, noise=noise)
        per_img, loss = masked_bce_per_image(logits, *_fold(task, y, valid))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        w = valid.float()
        per_fold = (per_img.detach().reshape(task.fold, -1) * w).sum(dim=1) / w.sum().clamp(min=1.0)
        return loss.detach(), per_fold

    return step


def make_eval_step(task):
    """``step(x, y, valid, generator) -> (loss, dice, precision, recall)``
    of one batch in eval mode; the metrics are (fold*B, C) with NaN on
    padding rows."""

    @torch.no_grad()
    def step(x, y, valid, generator):
        task.classifier.eval()
        logits = task.apply(x, generator=generator)
        y, valid = _fold(task, y, valid)
        _, loss = masked_bce_per_image(logits, y, valid)
        y_hat = torch.sigmoid(logits.float()) > 0.5
        vmask = torch.where(valid > 0, 1.0, float("nan"))[:, None]
        return loss, M.dice(y_hat, y) * vmask, M.precision(y_hat, y) * vmask, M.recall(y_hat, y) * vmask

    return step


def validate(config: Config, task, loader, generator: torch.Generator) -> Dict[str, float]:
    """Reference validate (trainers/train_baseline.py:99-144): the loss
    weighted by valid rows, the metrics by nanmean over images."""
    dev = next(task.classifier.parameters()).device
    eval_step = make_eval_step(task)
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
    return {
        "val/loss": float(np.sum(losses) / max(np.sum(weights), 1e-9)),
        "val/dice": float(np.nanmean(np.concatenate(dices))),
        "val/precision": float(np.nanmean(np.concatenate(precs))),
        "val/recall": float(np.nanmean(np.concatenate(recs))),
    }


def train_segmentation(config: Config, task, loaders: Dict[str, Any], logger: MetricsLogger) -> None:
    """The shared loop over ``task`` (a ``SegTask``: frozen backbone, trained
    head) on the head's device. Checkpoints hold ``{"backbone",
    "classifier", "opt_state", "step"}``; ``--resume_path`` restores them."""
    dev = next(task.classifier.parameters()).device
    optimizer = make_optimizer(config, task.classifier.parameters())
    train_step = make_train_step(task, optimizer)
    step = 0
    if config.resume_path and checkpoint_exists(config.resume_path):
        state, _ = load_checkpoint(config.resume_path, config, map_location=dev)
        task.unet.load_state_dict(state["backbone"])
        task.classifier.load_state_dict(state["classifier"])
        optimizer.load_state_dict(state["opt_state"])
        step = int(state["step"])
        print(f"Resumed from {config.resume_path} at step {step}")

    generator = torch.Generator(device=dev).manual_seed(config.seed)
    best_val_loss = float("inf")
    train_losses: List[torch.Tensor] = []
    fold_losses: List[torch.Tensor] = []
    t0, imgs_seen = time.time(), 0

    def make_state():
        return {"backbone": task.unet.state_dict(), "classifier": task.classifier.state_dict(),
                "opt_state": optimizer.state_dict(), "step": step}

    with graceful_shutdown() as should_stop:
        for batch in loaders["train"].repeat():
            step += 1
            loss, per_fold = train_step(
                to_nchw(batch["image"], dev), to_nchw(batch["mask"], dev),
                torch.from_numpy(batch["valid"]).to(dev), generator=generator,
            )
            # device scalars: reading them here would wait for the card every step
            train_losses.append(loss)
            fold_losses.append(per_fold)
            imgs_seen += int(batch["valid"].sum())

            if step % config.log_freq == 0 or config.debug:
                # read the window's losses (waiting for its steps) before the clock
                window_loss = torch.stack(train_losses).mean().item()
                dt = time.time() - t0
                logs = {"train/loss": window_loss, "train/imgs_per_sec": imgs_seen / max(dt, 1e-9)}
                if task.fold > 1:
                    mean_fold = torch.stack(fold_losses).mean(dim=0).tolist()
                    for name, v in zip(task.t_steps, mean_fold):
                        logs[f"train_loss/step_{name}"] = v
                logger.log(logs, step)
                train_losses, fold_losses = [], []
                t0, imgs_seen = time.time(), 0

            if step % config.val_freq == 0 or config.debug:
                val = validate(config, task, loaders["val"], generator)
                logger.log(val, step)
                if val["val/loss"] < best_val_loss and not config.debug:
                    best_val_loss = val["val/loss"]
                    save_checkpoint(f"{config.log_dir}/best", make_state(), config)
                elif val["val/loss"] > best_val_loss * 1.5 and config.early_stop:
                    return

            if config.ckpt_every and step % config.ckpt_every == 0:
                save_checkpoint(f"{config.log_dir}/step_{step}", make_state(), config)

            if should_stop():
                save_checkpoint(f"{config.log_dir}/interrupted", make_state(), config)
                print(f"[interrupt] saved {config.log_dir}/interrupted at step {step}")
                return

            if step >= config.max_steps or config.debug:
                return
