"""Driver: the DDPM backbone's training step, ``tedm_tpu_torch.trainers.
diffusion.make_steps(...).train_step``, looped over the window.

Set-up builds the step once, as the trainer's ``main`` does (the model from
``build_model`` with the seed's weights loaded, its EMA a copy of it,
``make_optimizer``'s Adam, TF32 off), and drives it through its first three
steps with the window's own feed (``inputs.StepFeed``: rows of a pool of
synthetic images that all differ over the three steps, timesteps and noise
handed in). Those steps build every kernel and warm cuDNN and the caching
allocator at the cell's shapes; their losses, the first gradient (from
Adam's first moment after one step) and the change of the weights and of
the EMA after the third are kept. The same object then runs the window.
Once the window has closed and the program is freed, the reference
(``reference/train.py``) follows the same three steps from the same weights
and inputs, in the precision the traffic states (``reference/precision.py``:
fp32, or bf16 operands and output with fp32 sums).

Traffic parameters (``traffic/<name>.json``): ``batch``, ``precision``
(``fp32`` or ``bf16``: the trainer's ``--mixed_precision``), ``kernels``
(the trainer's ``--use_pallas_*`` flags), ``pool`` (images, a multiple of
the batch, at least three batches), ``trace_units``.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, Optional

import torch

from portbench import compare, inputs
from portbench.drivers import common
from portbench.reference import precision
from portbench.reference import strict_fp32 as reference_strict_fp32
from portbench.reference import train as ref_train
from portbench.reference.diffusion import Schedule
from portbench.reference.unet import Unet as RefUnet, set_rounding

CHECKED_STEPS = 3
REFERENCE_ROWS = 16  # the reference's rows a block


def _config(cfg: Dict, mix: Dict):
    from tedm_tpu_torch.config import Config

    flags = {k: bool(v) for k, v in mix["kernels"].items()}
    return Config(experiment="img_only", dim=cfg["dim"], dim_mults=tuple(cfg["dim_mults"]),
                  channels=cfg["channels"], img_size=cfg["img_size"], timesteps=cfg["timesteps"],
                  beta_schedule=cfg["beta_schedule"], objective=cfg["objective"], lr=cfg["lr"],
                  ema_decay=cfg["ema_decay"], batch_size=mix["batch"],
                  mixed_precision=mix["precision"] == "bf16", **flags)


def _spec(cfg: Dict):
    with torch.device("meta"):
        return RefUnet(cfg["dim"], cfg["dim_mults"], cfg["channels"]).state_dict()


def _norms(tensors) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(list(tensors)))


def plant(fault: Optional[str], steps, optimizer, diffusion_module):
    """The program's step broken on purpose, for the checks of ``correct``:
    ``unchanged`` (the step leaves the state as it was), ``half_batch`` (half
    of the rows left out, the mean over the rest), ``altered`` (the loss
    doubled where the program produces it). Returns the step to call and
    what puts the program back."""
    step, undo = steps.train_step, (lambda: None)
    if fault == "unchanged":
        optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        def step(x, cond, valid, t, noise, _step=steps.train_step):
            h = x.shape[0] // 2
            return _step(x[:h], cond, valid[:h], t=t[:h], noise=noise[:h])
    elif fault == "altered":
        loss_fn = diffusion_module.train_loss
        diffusion_module.train_loss = lambda *a, **k: 2 * loss_fn(*a, **k)
        undo = lambda: setattr(diffusion_module, "train_loss", loss_fn)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault}")
    return step, undo


def run(cell: Dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        fault: Optional[str] = None, control: bool = False) -> Dict:
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers import diffusion
    from tedm_tpu_torch.trainers.common import make_optimizer
    from tedm_tpu_torch.utils.device import strict_fp32

    cfg, mix = cell["model"], cell["mix"]
    dev = torch.device(device)
    strict_fp32()
    config = _config(cfg, mix)
    spec = _spec(cfg)
    batch = mix["batch"]
    pool = inputs.images(seed, mix["pool"], cfg["img_size"], dev)
    feed = inputs.StepFeed(seed, pool, batch, cfg["timesteps"])
    checked = [feed(k) for k in range(CHECKED_STEPS)]

    unet = diffusion.build_model(config).to(dev)
    unet.load_state_dict(inputs.weights(spec, seed, "unet", dev))
    ema = copy.deepcopy(unet).requires_grad_(False)
    sched = make_schedule(config.timesteps, config.beta_schedule).to(dev)
    optimizer = make_optimizer(config, unet.parameters())
    steps = diffusion.make_steps(config, unet, sched, optimizer, ema)
    step, undo = plant(fault, steps, optimizer, diffusion)
    cond = torch.zeros((1, 1, 1, 1), device=dev)
    valid = torch.ones(batch, dtype=torch.bool, device=dev)
    common.free(dev)
    common.reset_peak(dev)

    names, params = zip(*unet.named_parameters())
    losses, grad = [], {}
    for k, (x, t, noise) in enumerate(checked):
        losses.append(step(x, cond, valid, t=t, noise=noise)[0])
        if k == 0:
            beta1 = optimizer.param_groups[0]["betas"][0]
            moments = [optimizer.state[p]["exp_avg"] if "exp_avg" in optimizer.state[p] else torch.zeros_like(p)
                       for p in params]
            grad = dict(zip(names, (_norms(moments) / (1 - beta1)).tolist()))
    with torch.no_grad():
        start = inputs.weights(spec, seed, "unet", dev)
        change = dict(zip(names, _norms([p - start[n] for n, p in zip(names, params)]).tolist()))
        ema_params = dict(ema.named_parameters())
        ema_change = dict(zip(names, _norms([ema_params[n] - start[n] for n in names]).tolist()))
        del start
    record = ref_train.Record([l.item() for l in losses], grad, change, ema_change)

    def unit(i: int) -> None:
        x, t, noise = feed(i)
        step(x, cond, valid, t=t, noise=noise)

    setup_s = time.perf_counter() - t_start
    win = common.window(unit, CHECKED_STEPS, seconds, dev)
    summary = None
    if trace:
        summary = common.traced(unit, CHECKED_STEPS + win["units"], mix["trace_units"], "train_step")
    peak = common.peak_bytes(dev)
    view = common.view(cell, "train", win, summary)
    undo()
    del steps, step, unet, ema, optimizer, params, feed, unit
    common.free(dev)

    reference_strict_fp32()
    ref_sched = Schedule(cfg["timesteps"], cfg["beta_schedule"], device=dev)

    def reference(operands, output):
        with dev:
            model = RefUnet(cfg["dim"], cfg["dim_mults"], cfg["channels"])
        model.load_state_dict(inputs.weights(spec, seed, "unet", dev))
        set_rounding(model, operands)
        return ref_train.run(model, ref_sched, checked, cfg["lr"], cfg["ema_decay"], min(REFERENCE_ROWS, batch),
                             out_rounding=output)

    ref = reference(precision.stored(mix["precision"]), precision.stored(mix["precision"]))
    if control:  # the reference in the precision below the configuration's, in the program's place
        record = reference(precision.control_rounding(mix["precision"]), precision.control_stored(mix["precision"]))
    return {"attempted": win["units"], "failed": 0, "memory_peak_bytes": peak,
            "e2e": {"imgs_per_s": win["units"] * batch / win["seconds"], "peak_mem_gib": peak / 2 ** 30,
                    "setup_s": setup_s},
            "view": view, **dict(zip(("numbers", "detail"), compare.training(record, ref)))}
