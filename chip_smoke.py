#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tedm_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. environment: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: every CUDA source in tedm_tpu_torch/kernels/csrc, one nvcc per
     source, all started together;
  3. linear attention forward vs plain at the serving shapes, and the
     forward and backward vs plain at the training shapes and at edge
     shapes, with device times (CUDA events);
  4. serving path: a full-width TEDM model (random weights from a seed)
     saved with the port's save_checkpoint and served through Predictor for
     4 requests; launches per request; one request traced with
     torch.profiler; one request's probabilities against the CPU plain path;
  5. training path (a): the DDPM backbone (36,245,377 parameters, batch 16,
     128x128) trained through tedm_tpu_torch.train.main with EMA, one
     validation at the last step with a 1000-step sample grid; step time,
     images/s, peak memory, kernel launches per step (8 forward, 8 backward);
  6. one training step at batch 16 traced with torch.profiler, then one at
     batch 2 on the card and on the CPU plain path from the same weights,
     t and noise: loss and gradients must agree;
  7. training path (b): the TEDM head trained on path (a)'s backbone through
     the same entry point, its val Dice, then one request served from its
     best checkpoint by Predictor;
  8. one JSON line listing every kernel, then the final JSON status line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
N_REQUESTS = 4
REPS = 25                      # timed repetitions per measurement (median)
LA_TOL = 2e-5                  # fp32 forward tolerance (KERNELS.json)
# fp32 VJP tolerance (KERNELS.json), relative to each gradient's largest
# entry, floored at 1e-3 so that a gradient that vanishes (N = 1) is held
# to 2e-7
LA_BWD_TOL = 2e-4
PATH_TOL = 1e-3                # card vs CPU plain path, ensembled probabilities
STEP_LOSS_TOL = 1e-4           # card vs CPU training step, relative loss
STEP_GRAD_TOL = 1e-3           # ... and gradients, relative to each tensor's largest entry
SERVE_SHAPES = [(8, 4, 32, n) for n in (256, 1024, 4096, 16384)]   # 2 calls each per request
TRAIN_SHAPES = [(16, 4, 32, n) for n in (256, 1024, 4096, 16384)]  # 2 calls each per step
A_STEPS = 30                   # training steps of path (a)
B_STEPS = 30                   # training steps of path (b)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def device_ms(fn, reps: int = REPS) -> float:
    """Median device time of one call of ``fn``, in ms. Before each call a
    spin kernel holds the card for ~1 ms, so the host has queued the call
    before the card reaches it and the events bracket device work only."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-3)).item()


class Phase:
    """Prints a phase's wall seconds when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        print(f"== {self.name}: {time.perf_counter() - self.t0:.1f} s", flush=True)


# substrings of device kernel names -> the kind of work, for the profiles
KERNEL_KINDS = (
    ("linear_attention forward kernel", ("context_partials", "combine_context", "apply_context")),
    ("linear_attention backward kernel", ("grad_partials", "combine_grad", "apply_grad")),
    ("convolution / gemm", ("conv", "cudnn", "xmma", "gemm", "fft", "dgrad", "wgrad",
                            "pointwise_mult_and_sum_complex")),
    ("optimizer / EMA (foreach)", ("multi_tensor", "foreach")),
    ("reduction / softmax / norm", ("reduce", "softmax", "norm")),
    ("elementwise / copy", ("elementwise", "copy", "cat", "index", "fill")),
)


def profile(label: str, fn) -> None:
    """One call of ``fn`` under torch.profiler: device time by kind of
    kernel and by kernel, and the share of the wall time the card was busy.
    The profiler's own overhead inflates the wall time, so the busy share
    is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    print(f"profile of {label}: {sum(e.count for e in kernels)} kernel launches, device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms wall ({100 * busy_ms / wall_ms:.1f} %)")
    by_kind = dict.fromkeys([k for k, _ in KERNEL_KINDS] + ["other"], 0.0)
    for e in kernels:
        name = e.key.lower()
        kind = next((k for k, subs in KERNEL_KINDS if any(s in name for s in subs)), "other")
        by_kind[kind] += e.self_device_time_total / 1e3
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {100 * ms / busy_ms:5.1f} %  {kind}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")


def read_metrics(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_forward(la, gen, scale):
    """Forward kernel vs plain at the serving and training shapes and at
    edges; per-shape rows with times."""
    from tedm_tpu_torch.kernels.bounds import bound

    rows = {}
    for shape in SERVE_SHAPES + TRAIN_SHAPES:
        n = shape[-1]
        q = torch.randn(shape, generator=gen, device="cuda") * 2
        k = torch.randn(shape, generator=gen, device="cuda") * 2
        # v carries the factor N that the math divides out, so outputs are
        # O(0.1) and the absolute tolerance is a real test at every N
        v = torch.randn(shape, generator=gen, device="cuda") * n
        out = la.linear_attention(q, k, v, scale)
        ref = la.linear_attention_reference(q, k, v, scale)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        # q, k, v read once and out written once (fp32); two d x d x N
        # contractions per (b, h) at 2 operations per multiply-add
        row = {
            "shape": list(shape),
            "max_abs_err": err,
            "max_abs_ref": ref.abs().max().item(),
            "ms": device_ms(lambda: la.linear_attention(q, k, v, scale)),
            "plain_ms": device_ms(lambda: la.linear_attention_reference(q, k, v, scale)),
            **bound(4 * q.numel() * 4, 2 * 2 * q.numel() * shape[2]),
        }
        rows[shape] = row
        print(f"linear_attention {shape}: max_abs_err {err:.3e} (|ref| <= {row['max_abs_ref']:.3f}, "
              f"tol {LA_TOL}) kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
              f"bound {1e3 * row['bound_ms']:.2f} us", flush=True)
        if not err <= LA_TOL:
            fail(f"linear_attention kernel disagrees with its plain version at {shape}: {err}")
        del q, k, v, out, ref
    for what, q, k, v in edge_inputs(gen):
        err = (la.linear_attention(q, k, v, scale) - la.linear_attention_reference(q, k, v, scale)).abs().max().item()
        if not err <= LA_TOL:
            fail(f"linear_attention kernel disagrees with its plain version at {what}: {err}")
    print("linear_attention edge shapes and qkv views: within tolerance", flush=True)
    return rows


def edge_inputs(gen):
    """Edges the path does not reach: N off the kernel's tiles, one column,
    one head, and the strided views of a qkv conv output."""
    for shape in [(1, 4, 32, 1), (2, 4, 32, 300), (3, 1, 32, 513), (1, 4, 32, 2 ** 16 + 7)]:
        q, k = (torch.randn(shape, generator=gen, device="cuda") * 2 for _ in range(2))
        yield shape, q, k, torch.randn(shape, generator=gen, device="cuda") * shape[-1]
    qkv = torch.randn(2, 3 * 128, 20, 20, generator=gen, device="cuda") * 2
    yield ("qkv views", *(t.reshape(2, 4, 32, 400) for t in qkv.chunk(3, dim=1)))


def check_backward(la, gen, scale):
    """Backward kernel vs its plain version at the training shapes and at
    the edges; per-shape rows with times."""
    from tedm_tpu_torch.kernels.bounds import bound

    rows = {}
    cases = [(s, *(torch.randn(s, generator=gen, device="cuda") * 2 for _ in range(2)),
              torch.randn(s, generator=gen, device="cuda") * s[-1]) for s in TRAIN_SHAPES]
    for i, (what, q, k, v) in enumerate(cases + list(edge_inputs(gen))):
        g = torch.randn(q.shape, generator=gen, device="cuda")
        if what == "qkv views":  # a gradient with a batch stride of its own
            g = torch.randn(2, 3 * 128, 400, generator=gen, device="cuda")[:, 128:256].reshape(2, 4, 32, 400)
        _, ctx, stats = la._forward(q, k, v, scale)
        got = la._backward(q, k, v, g, ctx, stats, scale)
        ref = la.linear_attention_backward_reference(q, k, v, g, scale)
        torch.cuda.synchronize()
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        if not max(errs) <= LA_BWD_TOL:
            fail(f"linear_attention backward disagrees with its plain version at {what}: "
                 f"relative errors (dq, dk, dv) {errs}")
        if i >= len(cases):
            continue
        shape = tuple(q.shape)
        b, h, d, n = shape
        # q, k, v and g read once, dq, dk and dv written once (fp32); the
        # JAX cost estimate's 10 * B*h*d*d*N operations (linear_attention.py:152)
        row = {
            "shape": list(shape),
            "max_abs_err": max((a - r).abs().max().item() for a, r in zip(got, ref)),
            "max_rel_err": max(errs),
            "ms": device_ms(lambda: la._backward(q, k, v, g, ctx, stats, scale)),
            "plain_ms": device_ms(lambda: la.linear_attention_backward_reference(q, k, v, g, scale)),
            **bound(7 * q.numel() * 4, 10 * b * h * d * d * n),
        }
        rows[shape] = row
        print(f"linear_attention backward {shape}: relative errors (dq, dk, dv) "
              f"{', '.join(f'{e:.2e}' for e in errs)} (tol {LA_BWD_TOL}) kernel {row['ms']:.4f} ms "
              f"plain {row['plain_ms']:.4f} ms bound {1e3 * row['bound_ms']:.2f} us", flush=True)
    print("linear_attention backward edge shapes and qkv views: within tolerance", flush=True)
    return rows


def serve(la, tmp):
    """Phase 4: the serving path. Returns its forward launches."""
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.serve.app import Predictor
    from tedm_tpu_torch.trainers.datasetdm import build_task
    from tedm_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = Config(log_dir=os.path.join(tmp, "serve", "run")).replace(
        experiment="TEDM", n_labelled_images=1, seed=SEED,
        saved_diffusion_model=os.path.join(tmp, "no_backbone"),
    ).apply_experiment_preset()
    task = build_task(cfg, device="cuda")  # random weights from cfg.seed
    logs = os.path.join(tmp, "serve", "logs")
    save_checkpoint(
        os.path.join(logs, "TEDM", "1", "best"),
        {"backbone": task.unet.state_dict(), "classifier": task.classifier.state_dict()},
        cfg,
    )
    del task
    rs = np.random.RandomState(SEED)
    imgs = [rs.rand(1, cfg.img_size, cfg.img_size, 1).astype(np.float32) for _ in range(N_REQUESTS)]
    predictor = Predictor(logs_root=logs, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    la.linear_attention.launches = la.linear_attention.backward_launches = 0
    latencies, masks, launches = [], [], []
    for img in imgs:
        before = la.linear_attention.launches
        t0 = time.perf_counter()
        masks.append(predictor.predict(img, "TEDM", 1))  # returns host numpy: synchronised
        latencies.append(1e3 * (time.perf_counter() - t0))
        launches.append(la.linear_attention.launches - before)
    fwd, bwd = la.linear_attention.launches, la.linear_attention.backward_launches
    peak = torch.cuda.max_memory_allocated()

    print(f"requests: {N_REQUESTS}; latency ms {[round(x, 3) for x in latencies]} "
          f"(the first includes loading the checkpoint); median of the rest "
          f"{statistics.median(latencies[1:]):.3f} ms; "
          f"linear_attention launches per request {launches}; "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)
    if launches != [8] * N_REQUESTS or bwd != 0:
        fail(f"expected 8 forward and no backward launches per request, got {launches} and {bwd}")
    profile("one request", lambda: predictor.predict(imgs[0], "TEDM", 1))
    for m in masks:
        if m.shape != (cfg.img_size, cfg.img_size) or not set(np.unique(m)) <= {0.0, 1.0}:
            fail(f"mask of shape {m.shape} with values {np.unique(m)[:5]}")

    # the same weights, image and noise through the plain path on the CPU
    noise = rs.randn(1, cfg.img_size, cfg.img_size, 1).astype(np.float32)
    probs_gpu = predictor._probabilities(imgs[0], "TEDM", 1, noise=noise)
    t0 = time.perf_counter()
    probs_cpu = Predictor(logs_root=logs, device="cpu")._probabilities(imgs[0], "TEDM", 1, noise=noise)
    cpu_s = time.perf_counter() - t0
    if probs_gpu.shape != (1, cfg.img_size, cfg.img_size, 1) or not np.isfinite(probs_gpu).all():
        fail(f"probabilities of shape {probs_gpu.shape}, finite: {np.isfinite(probs_gpu).all()}")
    path_err = float(np.abs(probs_gpu - probs_cpu).max())
    print(f"card vs CPU plain path: max_abs_err {path_err:.3e} (tol {PATH_TOL}); "
          f"probabilities in [{probs_gpu.min():.4f}, {probs_gpu.max():.4f}]; "
          f"CPU request {cpu_s:.1f} s", flush=True)
    if not path_err <= PATH_TOL:
        fail(f"card and CPU plain path disagree: {path_err}")
    return fwd


def train_backbone(la, tmp):
    """Phase 5: path (a) through the training entry point. Returns (best
    checkpoint, forward launches, backward launches)."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.train import main as train_main

    argv = ["--experiment", "img_only", "--synthetic_data", "--ema_decay", "0.999",
            "--max_steps", str(A_STEPS), "--val_freq", str(A_STEPS), "--log_freq", "1",
            "--max_val_steps", "1", "--seed", str(SEED),
            "--log_dir", os.path.join(tmp, "train", "run_a")]
    cfg = config_from_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    la.linear_attention.launches = la.linear_attention.backward_launches = 0
    t0 = time.perf_counter()
    train_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = la.linear_attention.launches, la.linear_attention.backward_launches
    peak = torch.cuda.max_memory_allocated()

    recs = read_metrics(cfg.log_dir)
    steps = [r for r in recs if "train/loss" in r]
    val = [r["val/loss"] for r in recs if "val/loss" in r]
    step_ms = [1e3 * cfg.batch_size / r["train/imgs_per_sec"] for r in steps]
    # validation: one batch of val_loss (chunks of 8 timesteps, one UNet call
    # each) and the sample grid's T UNet calls, 8 linear attentions per call
    n_t = len(range(0, cfg.timesteps, max(cfg.timesteps // cfg.val_steps, 1)))
    val_fwd = 8 * (math.ceil(n_t / 8) + cfg.timesteps)
    per_step = ((fwd - val_fwd) / len(steps), bwd / len(steps))
    losses = [r["train/loss"] for r in steps]
    print(f"path (a): {len(steps)} steps at batch {cfg.batch_size}, {cfg.img_size}^2, "
          f"{wall:.1f} s wall with validation; step ms {[round(x, 1) for x in step_ms]}; "
          f"median of steps 2-{len(steps)} {statistics.median(step_ms[1:]):.3f} ms = "
          f"{1e3 * cfg.batch_size / statistics.median(step_ms[1:]):.2f} imgs/s; "
          f"losses {losses[0]:.4f} .. {losses[-1]:.4f}; val loss {val}; "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB, validation included); "
          f"linear_attention launches: forward {fwd} ({val_fwd} in validation), "
          f"backward {bwd}; per step {per_step}", flush=True)
    if len(steps) != A_STEPS or not all(math.isfinite(x) for x in losses + val) or len(val) != 1:
        fail(f"path (a): {len(steps)} steps, losses {losses}, val {val}")
    if per_step != (8, 8):
        fail(f"path (a): expected 8 forward and 8 backward launches per step, got {per_step}")
    if not os.path.isfile(os.path.join(cfg.log_dir, "images", f"val_samples_{A_STEPS}.png")):
        fail("path (a) wrote no sample grid")

    # the input layer alone: the trainer's loader with nothing else running
    from tedm_tpu_torch.data.pipeline import build_dataloaders

    batches = build_dataloaders("CXR14", None, cfg.img_size, cfg.batch_size, cfg.num_workers,
                                seed=cfg.seed, synthetic=True)["train"].repeat()
    next(batches)
    t0 = time.perf_counter()
    for _ in range(20):
        next(batches)
    dt = time.perf_counter() - t0
    batches.close()
    print(f"path (a) loader alone ({cfg.num_workers} threads): {1e3 * dt / 20:.3f} ms a batch of "
          f"{cfg.batch_size}, {20 * cfg.batch_size / dt:.1f} imgs/s", flush=True)
    return os.path.join(cfg.log_dir, "best"), fwd, bwd


def step_card_vs_cpu():
    """Phase 6: a training step at batch 16 under the profiler, then one at
    batch 2 on the card and on the CPU from the same weights, t and noise."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers import diffusion as D
    from tedm_tpu_torch.trainers.common import make_optimizer, to_nchw

    cfg = config_from_args(["--experiment", "img_only", "--synthetic_data", "--seed", str(SEED),
                            "--log_dir", os.path.join(tempfile.gettempdir(), "unused")])
    data = SyntheticCXRDataset("cxr_train", 16, cfg.img_size, labelled=False, seed=SEED)
    x = np.stack([data[i] for i in range(16)])
    gen = torch.Generator().manual_seed(SEED)
    t = torch.randint(0, cfg.timesteps, (16,), generator=gen)
    noise = torch.randn(16, 1, cfg.img_size, cfg.img_size, generator=gen)
    sched = make_schedule(cfg.timesteps, cfg.beta_schedule)

    def run(device, rows):
        unet = D.build_model(cfg).to(device)
        steps = D.make_steps(cfg, unet, sched.to(device), make_optimizer(cfg, unet.parameters()))
        args = (to_nchw(x[:rows], device), torch.zeros(1, device=device), torch.ones(rows, device=device))
        return unet, steps, args

    unet, steps, args = run("cuda", 16)
    for _ in range(3):
        steps.train_step(*args, t=t[:16].cuda(), noise=noise.cuda())
    profile("one training step at batch 16", lambda: steps.train_step(*args, t=t.cuda(), noise=noise.cuda()))
    del unet, steps, args

    results = {}
    for device in ("cuda", "cpu"):
        unet, steps, args = run(device, 2)
        loss, _ = steps.train_step(*args, t=t[:2].to(device), noise=noise[:2].to(device))
        results[device] = (loss.item(), {n: p.grad.cpu() for n, p in unet.named_parameters()})
    (loss_g, grads_g), (loss_c, grads_c) = results["cuda"], results["cpu"]
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    grad_errs = {n: rel_err(grads_g[n], grads_c[n]) for n in grads_c}
    worst = max(grad_errs, key=grad_errs.get)
    print(f"training step at batch 2, card vs CPU plain path: loss {loss_g:.6f} vs {loss_c:.6f} "
          f"(relative {loss_err:.2e}, tol {STEP_LOSS_TOL}); gradients of {len(grad_errs)} tensors, "
          f"worst relative to the tensor's largest entry {grad_errs[worst]:.2e} at {worst} "
          f"(tol {STEP_GRAD_TOL}), median {statistics.median(grad_errs.values()):.2e}", flush=True)
    if not (math.isfinite(loss_g) and loss_err <= STEP_LOSS_TOL and grad_errs[worst] <= STEP_GRAD_TOL):
        fail("the training step on the card disagrees with the CPU plain path")


def train_head(la, tmp, backbone):
    """Phase 7: path (b) on path (a)'s backbone, then one request served
    from its best checkpoint. Returns its forward launches."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.serve.app import Predictor
    from tedm_tpu_torch.train import main as train_main

    logs = os.path.join(tmp, "train", "logs")
    argv = ["--experiment", "TEDM", "--n_labelled_images", "1", "--synthetic_data",
            "--saved_diffusion_model", backbone, "--max_steps", str(B_STEPS),
            "--val_freq", str(B_STEPS), "--log_freq", "1", "--seed", str(SEED),
            "--log_dir", os.path.join(logs, "run_b")]
    cfg = config_from_args(argv)
    la.linear_attention.launches = la.linear_attention.backward_launches = 0
    t0 = time.perf_counter()
    train_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = la.linear_attention.launches, la.linear_attention.backward_launches

    recs = read_metrics(cfg.log_dir)
    steps = [r for r in recs if "train/loss" in r]
    val = [r for r in recs if "val/dice" in r]
    step_ms = [1e3 * r["train/imgs_per_sec"] ** -1 for r in steps]
    print(f"path (b): {len(steps)} steps of 1 image x 8 timesteps, {wall:.1f} s wall with "
          f"validation; median step {statistics.median(step_ms[1:]):.3f} ms; losses "
          f"{steps[0]['train/loss']:.4f} .. {steps[-1]['train/loss']:.4f}; val {val}; "
          f"linear_attention launches: forward {fwd}, backward {bwd}", flush=True)
    # one UNet call of 8 timesteps per step and per val batch (25 images, 2 batches)
    if len(steps) != B_STEPS or len(val) != 1 or fwd != 8 * (B_STEPS + 2) or bwd != 0:
        fail(f"path (b): {len(steps)} steps, val {val}, launches {fwd} / {bwd}")
    if not all(math.isfinite(v) for v in val[0].values()):
        fail(f"path (b): val metrics {val[0]}")

    mask = Predictor(logs_root=logs, device="cuda").predict(
        np.random.RandomState(SEED).rand(1, cfg.img_size, cfg.img_size, 1).astype(np.float32), "TEDM", 1)
    if mask.shape != (cfg.img_size, cfg.img_size) or not set(np.unique(mask)) <= {0.0, 1.0}:
        fail(f"path (b): served mask of shape {mask.shape}")
    print(f"path (b): served one request from {cfg.log_dir}/best, mask foreground {mask.mean():.4f}")
    return fwd


def per_step_sum(rows, shapes) -> dict:
    """Times and bounds of one request's or step's calls: each shape twice,
    once on the way down and once on the way up."""
    return {key: 2 * sum(rows[s][key] for s in shapes) for key in ("ms", "plain_ms", "bound_ms")}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the port on a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tedm_tpu_torch.kernels import _build
    from tedm_tpu_torch.kernels import linear_attention as la

    with Phase("1. environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    with Phase("2. build"):
        sources = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
        for name in sources:  # never reuse a library from an earlier run
            if os.path.exists(_build.library_path(name)):
                os.unlink(_build.library_path(name))
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            for name, path in zip(sources, pool.map(_build.build, sources)):
                print(f"built {name}: {os.path.relpath(path)}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scale = 32 ** -0.5
    with Phase("3. kernels vs plain"):
        fwd_rows = check_forward(la, gen, scale)
        bwd_rows = check_backward(la, gen, scale)

    with tempfile.TemporaryDirectory() as tmp:
        with Phase("4. serving path"):
            serve_fwd = serve(la, tmp)
        with Phase("5. training path (a): backbone"):
            backbone, a_fwd, a_bwd = train_backbone(la, tmp)
        with Phase("6. training step: profile, card vs CPU"):
            step_card_vs_cpu()
        with Phase("7. training path (b): TEDM head"):
            b_fwd = train_head(la, tmp, backbone)

    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "source": "tedm_tpu_torch/kernels/csrc/linear_attention.cu",
        "replaces": "tedm_tpu/ops/pallas/linear_attention.py:122",
        "launches": serve_fwd + a_fwd + b_fwd,
        "launches_by_path": {"serving": serve_fwd, "training (a)": a_fwd, "training (b)": b_fwd},
        "max_abs_err": max(r["max_abs_err"] for r in fwd_rows.values()),
        # times and bound of one serving request's 8 calls
        **per_step_sum(fwd_rows, SERVE_SHAPES),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in fwd_rows.values()) else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
        "train_step": per_step_sum(fwd_rows, TRAIN_SHAPES),
        "per_shape": list(fwd_rows.values()),
    }, {
        "name": "linear_attention_backward",
        "route": "cuda",
        "source": "tedm_tpu_torch/kernels/csrc/linear_attention.cu",
        "replaces": "tedm_tpu/ops/pallas/linear_attention.py:141",
        "launches": a_bwd,
        "launches_by_path": {"training (a)": a_bwd},
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
        "max_rel_err": max(r["max_rel_err"] for r in bwd_rows.values()),
        # times and bound of one training step's 8 calls
        **per_step_sum(bwd_rows, TRAIN_SHAPES),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bwd_rows.values()) else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
        "per_shape": list(bwd_rows.values()),
    }]
    for kern in kernels:
        if kern["launches"] == 0:
            fail(f"{kern['name']} was never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
