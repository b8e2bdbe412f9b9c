"""Driver: TEDM's served prediction, ``tedm_tpu_torch.serve.app.Predictor.
predict``, one image a request from one client in a closed loop.

Set-up writes a TEDM checkpoint of the seed's weights (the backbone and
the shared head, with the configuration's precision and kernel flags)
under ``$TMPDIR``, renders a pool of synthetic images on the card and takes
them to the host, and opens a ``Predictor`` on it. Warm-up requests load
the checkpoint, run the first request eagerly and capture its CUDA graph,
then replay it. In the window each request is the next image of the pool
as host numpy (1, H, W, 1); its latency is the host clock around
``predict``, which returns a host mask. The probabilities the mask is made
from (``Predictor._probabilities``, whose result ``predict`` thresholds at
0.5) are kept. Once the window has closed and the program is freed, the
reference (``reference/head.py``) recomputes a sample of the requests,
drawn from the seed, from the same weights, images and noise.

Traffic parameters (``traffic/<name>.json``): ``precision`` and
``kernels`` as the head's config states them (its ``--mixed_precision``
and ``--use_pallas_*``), ``training_size`` (the checkpoint's folder),
``pool`` (distinct images), ``warmup`` (requests), ``sample`` (requests
checked), ``trace_units``.
"""

from __future__ import annotations

import os
import random
import shutil
import tempfile
import time
from typing import Dict, Optional

import torch

from portbench import compare, harness, inputs
from portbench.drivers import common
from portbench.reference import strict_fp32 as reference_strict_fp32
from portbench.reference.diffusion import Schedule
from portbench.reference.head import PixelClassifier, probabilities
from portbench.reference.unet import Unet as RefUnet, set_rounding

REFERENCE_IMAGES = 4  # the reference's images a block


def _config(cfg: Dict, mix: Dict, root: str):
    from tedm_tpu_torch.config import Config

    flags = {k: bool(v) for k, v in mix["kernels"].items()}
    return Config(experiment="TEDM", shared_weights_over_timesteps=True, t_steps_to_save=tuple(cfg["t_steps"]),
                  n_labelled_images=mix["training_size"], dim=cfg["dim"], dim_mults=tuple(cfg["dim_mults"]),
                  channels=cfg["channels"], img_size=cfg["img_size"], timesteps=cfg["timesteps"],
                  beta_schedule=cfg["beta_schedule"], mixed_precision=mix["precision"] == "bf16",
                  saved_diffusion_model=os.path.join(root, "no_backbone"), log_dir=os.path.join(root, "run"),
                  **flags)


def _models(cfg: Dict, device):
    with torch.device(device):
        return (RefUnet(cfg["dim"], cfg["dim_mults"], cfg["channels"]),
                PixelClassifier(cfg["dim"] * sum(cfg["dim_mults"])))


def plant(fault: Optional[str], app, probs_fn):
    """The program broken on purpose, for the checks of ``correct``:
    ``half_batch`` (half of the folded timesteps left out, the mean over the
    rest), ``altered`` (each answer's first pixel set to 0 where it is
    produced). Returns the probabilities' function and what puts the
    program back."""
    undo = lambda: None
    if fault == "half_batch":
        load = app.load_experiment

        def halved(*a, **k):
            config, task = load(*a, **k)
            task.t_steps = task.t_steps[: len(task.t_steps) // 2]
            task.fold = len(task.t_steps)
            return config, task

        app.load_experiment = halved
        undo = lambda: setattr(app, "load_experiment", load)
    elif fault == "altered":
        def altered(*a, _fn=probs_fn, **k):
            out = _fn(*a, **k)
            out[0, 0, 0, 0] = 0.0
            return out

        probs_fn = altered
    elif fault is not None:
        raise ValueError(f"unknown fault {fault}")
    return probs_fn, undo


def run(cell: Dict, seed: int, seconds: float, trace: bool, t_start: float, device="cuda",
        fault: Optional[str] = None, control: bool = False) -> Dict:
    root = os.path.join(tempfile.gettempdir(), "portbench_" + cell["name"])
    shutil.rmtree(root, ignore_errors=True)
    try:
        return _run(cell, seed, seconds, trace, t_start, torch.device(device), fault, control, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(cell, seed, seconds, trace, t_start, dev, fault, control, root) -> Dict:
    from tedm_tpu_torch.serve import app
    from tedm_tpu_torch.utils.checkpoint import save_checkpoint
    from tedm_tpu_torch.utils.device import strict_fp32

    cfg, mix = cell["model"], cell["mix"]
    strict_fp32()
    size, n_pool = mix["training_size"], mix["pool"]
    logs = os.path.join(root, "logs")
    unet_spec, head_spec = (m.state_dict() for m in _models(cfg, "meta"))
    state = {"backbone": inputs.weights(unet_spec, seed, "unet", dev),
             "classifier": inputs.weights(head_spec, seed, "head", dev)}
    save_checkpoint(os.path.join(logs, app.MODEL_FOLDERS["TEDM"], str(size), "best"), state,
                    _config(cfg, mix, root))
    del state
    pool = inputs.images(seed, n_pool, cfg["img_size"], dev)
    requests = pool.permute(0, 2, 3, 1).cpu().numpy()  # the requests' host images, (n, H, W, 1)
    common.free(dev)
    common.reset_peak(dev)

    predictor = app.Predictor(logs_root=logs, device=dev)
    probs_fn, undo = plant(fault, app, predictor._probabilities)
    answers = []

    def recording(*a, **k):
        answers.append(probs_fn(*a, **k))
        return answers[-1]

    predictor._probabilities = recording

    def unit(i: int) -> None:
        j = i % n_pool
        predictor.predict(requests[j:j + 1], "TEDM", size)

    latencies = []

    def timed(i: int) -> None:
        t0 = time.perf_counter()
        unit(i)
        latencies.append(time.perf_counter() - t0)

    for i in range(mix["warmup"]):
        unit(i)
    setup_s = time.perf_counter() - t_start
    answers.clear()
    win = common.window(timed, mix["warmup"], seconds, dev)
    summary = None
    if trace:
        summary = common.traced(unit, mix["warmup"] + win["units"], mix["trace_units"], "predict")
    peak = common.peak_bytes(dev)
    view = common.view(cell, "serve", win, summary)
    undo()
    del predictor, unit, timed, recording
    common.free(dev)

    picked = sorted(random.Random(inputs.stream(seed, "sample")).sample(range(win["units"]),
                                                                       min(mix["sample"], win["units"])))
    reference_strict_fp32()
    sched = Schedule(cfg["timesteps"], cfg["beta_schedule"], device=dev)
    fold = len(cfg["t_steps"])
    noise = inputs.serving_noise((fold, cfg["channels"], cfg["img_size"], cfg["img_size"]), cfg["noise_seed"], dev)

    def reference(rounding=None):
        unet, head = _models(cfg, dev)
        unet.load_state_dict(inputs.weights(unet_spec, seed, "unet", dev))
        head.load_state_dict(inputs.weights(head_spec, seed, "head", dev))
        for m in (unet, head):
            set_rounding(m.eval(), rounding)
        out = []
        with torch.no_grad():
            for b in range(0, len(picked), REFERENCE_IMAGES):
                idx = [(mix["warmup"] + i) % n_pool for i in picked[b:b + REFERENCE_IMAGES]]
                p = probabilities(unet, head, sched, pool[idx], cfg["t_steps"],
                                  noise.repeat_interleave(len(idx), dim=0))
                out += list(p.permute(0, 2, 3, 1).cpu())
        return out

    ref = reference()
    served = [torch.from_numpy(answers[i][0]) for i in picked]
    if control:  # the reference in the precision below the configuration's, in the program's place
        from portbench.reference.precision import control_rounding

        served = reference(control_rounding(mix["precision"]))
    ms = [1e3 * s for s in latencies]
    return {"attempted": win["units"], "failed": 0, "memory_peak_bytes": peak,
            "e2e": {"request_ms_p50": harness.percentile(ms, 50), "request_ms_p95": harness.percentile(ms, 95),
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
            "view": view, "numbers": compare.serving(served, ref)}
