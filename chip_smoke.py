#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tedm_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. environment: the card's name and power limit (nvidia-smi); TF32 off,
     and bf16 products summed in fp32 (no reduced-precision split-K);
  2. build: every CUDA source in tedm_tpu_torch/kernels/csrc, one nvcc per
     source, all started together;
  3. linear attention forward vs plain at the serving shapes, and the
     forward and backward vs plain at the training shapes and at edge
     shapes; the fused PreNorm linear-attention block (bf16) vs plain at
     the serving and training shapes and at edges, on inputs where every
     stage of the attention moves the output, with controls (the plain
     version with a stage altered) that must read above the tolerance;
     device times (CUDA events) beside each kernel's bound;
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
  8. bf16 serving path: phase 4's weights under a ``mixed_precision``
     config, as phase 4 (8 fused-block launches a request, no
     linear-attention launch), and the bf16-vs-fp32 difference reported;
  9. bf16 training path (a): ``--mixed_precision`` backbone steps at batch
     16 through train.main (8 fused-block launches a step, none of the
     linear-attention kernels), without validation (its sample grid);
 10. a bf16 training step profiled at batch 16, then one at batch 2 on the
     card and on the CPU plain path;
 11. bf16 training path (b): a ``--mixed_precision`` TEDM head on phase
     9's backbone, then one request served from its best checkpoint;
 12. one JSON line listing every kernel, then the final JSON status line.
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
A_STEPS = 20                   # training steps of path (a)
B_STEPS = 15                   # training steps of path (b)
BLOCK_TOL = 5e-2               # bf16 forward tolerance (KERNELS.json), absolute
# card vs CPU in bf16: both round every activation to bf16, but cuDNN and
# the CPU's convolutions sum in other orders, and the fused kernel rounds
# exp(k - max) at its chunk's max. Measured on an H100: 4.2e-4 to 4.4e-4 in
# three runs, against probabilities that spread +-0.037 around 0.5; the
# limit is 7x the reading and a tenth of that spread
BF16_PATH_TOL = 3e-3
# ... and a training step: the loss 1e-2 relative, each gradient 5e-2 of its
# largest entry (bf16 rounding of the activations in the forward and the
# backward, summed in other orders)
BF16_STEP_LOSS_TOL = 1e-2
BF16_STEP_GRAD_TOL = 5e-2


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
    ("prenorm_linear_attention kernel", ("kv_partials", "::combine(", "apply_block")),
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
    # device events, less user annotations (an optimizer step's range), whose
    # time is that of the kernels inside them
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
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


def block_shapes(batch: int) -> list:
    """(B, C, N) of the default UNet's 8 fused blocks, in call order."""
    from tedm_tpu_torch.kernels.bounds import unet_stages

    return [(batch, c, side * side) for c, side in unet_stages()[0]]


def block_inputs(gen, b, c, n, x=None):
    """x (B, C, N) bf16 and the block's fp32 weights, scaled so that every
    stage of the attention moves the output. At a conv's default init the
    context is about N**-1.5 and the attention's share of the output falls
    below one bf16 ulp. Here the v rows of W_qkv carry the factor N that the
    context divides out, the k rows are doubled (k's softmax over N then
    weighs some hundreds of columns, across chunks), W_out is 4x, so that
    W_out attn is of the order of b_out and var(o) is 1e-2 or more, far
    above the norm's eps. x at 0.5 and g_out at 0.5 keep |out| below 4,
    where one bf16 ulp is 1.56e-2."""
    r = lambda *shape: torch.randn(*shape, generator=gen, device="cuda")
    if x is None:
        x = (0.5 * r(b, c, n)).bfloat16()
    w_qkv = r(3 * 128, c) * c ** -0.5
    w_qkv[128:256] *= 2
    w_qkv[256:] *= n
    return (x, 1 + 0.1 * r(c), w_qkv, 4 * r(c, 128) * 128 ** -0.5, 0.1 * r(c), 0.5 * (1 + 0.1 * r(c)))


def block_controls(args):
    """The inputs with one stage altered, for the plain version: the context
    zeroed (v rows of W_qkv 0), k's softmax over N made uniform (k rows 0),
    and the q or the k rows of each head rotated by one. The kernel must
    differ from each of these by more than BLOCK_TOL, or the check could not
    see that stage. At N = 1 k's softmax is 1 and attn = scale v whatever q
    is, so there only the context is held."""
    x, g_in, w_qkv, w_out, b_out, g_out = args
    rot = torch.cat([h * 32 + torch.roll(torch.arange(32), 1) for h in range(4)]).to(w_qkv.device)
    alter = {"context 0": lambda w: w[256:].zero_(), "k uniform": lambda w: w[128:256].zero_(),
             "q rotated": lambda w: w[:128].copy_(w[:128][rot]),
             "k rotated": lambda w: w[128:256].copy_(w[128:256][rot])}
    for what, fn in alter.items():
        if x.shape[-1] > 1 or what == "context 0":
            w = w_qkv.clone()
            fn(w)
            yield what, (x, g_in, w, w_out, b_out, g_out)


def check_block(ab, gen):
    """The fused block's kernel vs its plain version at the serving (batch 8)
    and training (batch 16) shapes and at edges; per-shape rows with times."""
    from tedm_tpu_torch.kernels.bounds import BF16_FLOPS_PER_S, bound

    rows = {}
    with torch.no_grad():
        for shape in block_shapes(8) + block_shapes(16):
            if shape in rows:  # the up and down paths share shapes
                continue
            b, c, n = shape
            args = block_inputs(gen, b, c, n)
            err, control = block_errors(ab, args, shape)
            # x read and out written (bf16), the weights read (fp32); the qkv and
            # to_out products and the two head-blocked attention contractions
            # on the bf16 tensor cores
            row = {
                "shape": list(shape),
                "max_abs_err": err,
                "min_control_err": control,
                "ms": device_ms(lambda: ab.prenorm_linear_attention(*args)),
                "plain_ms": device_ms(lambda: ab.prenorm_linear_attention_reference(*args)),
                **bound(2 * 2 * b * c * n + 4 * (4 * 128 * c + 3 * c),
                        2 * b * n * 4 * 128 * c + 4 * b * 128 * 32 * n, BF16_FLOPS_PER_S),
            }
            rows[shape] = row
            print(f"prenorm_linear_attention {shape}: max_abs_err {err:.3e} (tol {BLOCK_TOL}; controls "
                  f">= {control:.3f}) kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms bound "
                  f"{1e3 * row['bound_ms']:.2f} us ({row['bound_by']})", flush=True)
            del args
        wide = (0.5 * torch.randn(2, 3 * 64, 1000, generator=gen, device="cuda")).bfloat16()
        edges = [(shape, block_inputs(gen, *shape)) for shape in
                 [(1, 64, 1), (2, 64, 300), (1, 128, 513), (3, 256, 100), (1, 512, 17), (1, 64, 2 ** 16)]]
        edges.append(("x with a batch stride of its own", block_inputs(gen, 2, 64, 1000, wide[:, 64:128])))
        for what, args in edges:
            err, control = block_errors(ab, args, what)
            rows[what if isinstance(what, tuple) else (what,)] = {"max_abs_err": err, "min_control_err": control}
    print("prenorm_linear_attention edge shapes and a strided x: within tolerance, max_abs_err "
          f"{max(r['max_abs_err'] for r in rows.values()):.3e}; controls read "
          f"{min(r['min_control_err'] for r in rows.values()):.3f} or more", flush=True)
    return rows


def block_errors(ab, args, what):
    """The kernel's largest error against the plain version, and the least
    of its differences from the plain version on each control's inputs."""
    out = ab.prenorm_linear_attention(*args).float()
    err = (out - ab.prenorm_linear_attention_reference(*args).float()).abs().max().item()
    if not err <= BLOCK_TOL:
        fail(f"prenorm_linear_attention kernel disagrees with its plain version at {what}: {err}")
    controls = {}
    for name, altered in block_controls(args):
        controls[name] = (out - ab.prenorm_linear_attention_reference(*altered).float()).abs().max().item()
        if not controls[name] > BLOCK_TOL:
            fail(f"prenorm_linear_attention check at {what} cannot see its {name} control: {controls[name]}")
    return err, min(controls.values())


def calls_sum(rows, shapes) -> dict:
    """Times and bound summed over calls of the given shapes, one a shape
    as listed."""
    return {key: sum(rows[s][key] for s in shapes) for key in ("ms", "plain_ms", "bound_ms")}


def serve(la, ab, tmp, mixed: bool):
    """Phases 4 and 8: the serving path. fp32: a TEDM model with random
    weights from the seed, saved and served; bf16 (``mixed``): the same
    weights under a config with ``mixed_precision``. Returns the launches of
    the path's kernel: the linear-attention forward in fp32, the fused block
    in bf16."""
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.serve.app import Predictor
    from tedm_tpu_torch.trainers.datasetdm import build_task
    from tedm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    label = "bf16 " if mixed else ""
    logs32 = os.path.join(tmp, "serve", "logs")
    if mixed:
        state, cfg = load_checkpoint(os.path.join(logs32, "TEDM", "1", "best"), verbose=False)
        cfg = cfg.replace(mixed_precision=True)
        logs = os.path.join(tmp, "serve_bf16", "logs")
    else:
        cfg = Config(log_dir=os.path.join(tmp, "serve", "run")).replace(
            experiment="TEDM", n_labelled_images=1, seed=SEED,
            saved_diffusion_model=os.path.join(tmp, "no_backbone"),
        ).apply_experiment_preset()
        task = build_task(cfg, device="cuda")  # random weights from cfg.seed
        state = {"backbone": task.unet.state_dict(), "classifier": task.classifier.state_dict()}
        del task
        logs = logs32
    save_checkpoint(os.path.join(logs, "TEDM", "1", "best"), state, cfg)
    del state
    rs = np.random.RandomState(SEED)
    imgs = [rs.rand(1, cfg.img_size, cfg.img_size, 1).astype(np.float32) for _ in range(N_REQUESTS)]
    predictor = Predictor(logs_root=logs, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernel = "prenorm_linear_attention" if mixed else "linear_attention"
    counter = getattr(ab if mixed else la, kernel)
    reset_launches(la, ab)
    latencies, masks, launches = [], [], []
    for img in imgs:
        before = counter.launches
        t0 = time.perf_counter()
        masks.append(predictor.predict(img, "TEDM", 1))  # returns host numpy: synchronised
        latencies.append(1e3 * (time.perf_counter() - t0))
        launches.append(counter.launches - before)
    total = counter.launches
    others = sum(read_launches(la, ab)) - total
    peak = torch.cuda.max_memory_allocated()

    print(f"{label}requests: {N_REQUESTS}; latency ms {[round(x, 3) for x in latencies]} "
          f"(the first includes loading the checkpoint); median of the rest "
          f"{statistics.median(latencies[1:]):.3f} ms; {kernel} launches per request {launches}; "
          f"launches of the other kernels {others}; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    if launches != [8] * N_REQUESTS or others != 0:
        fail(f"expected 8 {kernel} launches per {label}request and no other kernel, got {launches} and {others}")
    unet_dtype = next(iter(predictor._cache.values()))[1].unet.compute_dtype
    if unet_dtype != (torch.bfloat16 if mixed else torch.float32):
        fail(f"the {label}checkpoint was served in {unet_dtype}")
    profile(f"one {label}request", lambda: predictor.predict(imgs[0], "TEDM", 1))
    for m in masks:
        if m.shape != (cfg.img_size, cfg.img_size) or not set(np.unique(m)) <= {0.0, 1.0}:
            fail(f"{label}mask of shape {m.shape} with values {np.unique(m)[:5]}")

    # the same weights, image and noise through the plain path on the CPU
    noise = rs.randn(1, cfg.img_size, cfg.img_size, 1).astype(np.float32)
    probs = predictor._probabilities(imgs[0], "TEDM", 1, noise=noise)
    t0 = time.perf_counter()
    probs_cpu = Predictor(logs_root=logs, device="cpu")._probabilities(imgs[0], "TEDM", 1, noise=noise)
    cpu_s = time.perf_counter() - t0
    if probs.shape != (1, cfg.img_size, cfg.img_size, 1) or not np.isfinite(probs).all():
        fail(f"{label}probabilities of shape {probs.shape}, finite: {np.isfinite(probs).all()}")
    path_err = float(np.abs(probs - probs_cpu).max())
    tol = BF16_PATH_TOL if mixed else PATH_TOL
    print(f"{label}card vs CPU plain path: max_abs_err {path_err:.3e} (tol {tol}); probabilities in "
          f"[{probs.min():.4f}, {probs.max():.4f}], |p - 0.5| <= {np.abs(probs - 0.5).max():.4f}; "
          f"CPU request {cpu_s:.1f} s", flush=True)
    if mixed:
        probs32 = Predictor(logs_root=logs32, device="cuda")._probabilities(imgs[0], "TEDM", 1, noise=noise)
        print(f"bf16 vs fp32 from the same weights and noise (a report, not a gate): probabilities "
              f"max_abs_diff {float(np.abs(probs - probs32).max()):.3e}, mean "
              f"{float(np.abs(probs - probs32).mean()):.3e}; masks differ at "
              f"{int(((probs > 0.5) != (probs32 > 0.5)).sum())} of {probs.size} pixels", flush=True)
    if not path_err <= tol:
        fail(f"{label}card and CPU plain path disagree: {path_err}")
    return total


def reset_launches(la, ab) -> None:
    la.linear_attention.launches = la.linear_attention.backward_launches = 0
    ab.prenorm_linear_attention.launches = 0


def read_launches(la, ab) -> tuple:
    """(linear-attention forward, its backward, fused block) launches."""
    return (la.linear_attention.launches, la.linear_attention.backward_launches,
            ab.prenorm_linear_attention.launches)


def train_backbone(la, ab, tmp, mixed: bool):
    """Phases 5 and 9: path (a) through the training entry point. fp32: with
    one validation at the last step (its 1000-step sample grid); bf16
    (``mixed``): without validation, a checkpoint at the last step. Returns
    (checkpoint, launches of the linear-attention forward, of its backward,
    of the fused block)."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.train import main as train_main

    label = "bf16 path (a)" if mixed else "path (a)"
    argv = ["--experiment", "img_only", "--synthetic_data", "--ema_decay", "0.999",
            "--max_steps", str(A_STEPS), "--log_freq", "1", "--seed", str(SEED),
            "--log_dir", os.path.join(tmp, "train_bf16" if mixed else "train", "run_a")]
    argv += (["--mixed_precision", "--val_freq", str(10 * A_STEPS), "--ckpt_every", str(A_STEPS)] if mixed
             else ["--val_freq", str(A_STEPS), "--max_val_steps", "1"])
    cfg = config_from_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(la, ab)
    t0 = time.perf_counter()
    train_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd, fused = read_launches(la, ab)
    peak = torch.cuda.max_memory_allocated()

    recs = read_metrics(cfg.log_dir)
    steps = [r for r in recs if "train/loss" in r]
    val = [r["val/loss"] for r in recs if "val/loss" in r]
    step_ms = [1e3 * cfg.batch_size / r["train/imgs_per_sec"] for r in steps]
    # fp32 validation: one batch of val_loss (chunks of 8 timesteps, one UNet
    # call each) and the sample grid's T UNet calls, 8 linear attentions per call
    n_t = len(range(0, cfg.timesteps, max(cfg.timesteps // cfg.val_steps, 1)))
    val_fwd = 0 if mixed else 8 * (math.ceil(n_t / 8) + cfg.timesteps)
    per_step = tuple(x / max(len(steps), 1) for x in (fwd - val_fwd, bwd, fused))
    losses = [r["train/loss"] for r in steps]
    print(f"{label}: {len(steps)} steps at batch {cfg.batch_size}, {cfg.img_size}^2, "
          f"{wall:.1f} s wall{'' if mixed else ' with validation'}; step ms {[round(x, 1) for x in step_ms]}; "
          f"median of steps 2-{len(steps)} {statistics.median(step_ms[1:]):.3f} ms = "
          f"{1e3 * cfg.batch_size / statistics.median(step_ms[1:]):.2f} imgs/s; "
          f"losses {losses[0]:.4f} .. {losses[-1]:.4f}; val loss {val}; "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB"
          f"{'' if mixed else ', validation included'}); launches: linear_attention forward {fwd} "
          f"({val_fwd} in validation), backward {bwd}, prenorm_linear_attention {fused}; per step "
          f"{per_step}", flush=True)
    if len(steps) != A_STEPS or not all(math.isfinite(x) for x in losses + val) or len(val) != (0 if mixed else 1):
        fail(f"{label}: {len(steps)} steps, losses {losses}, val {val}")
    if per_step != ((0, 0, 8) if mixed else (8, 8, 0)):
        fail(f"{label}: expected 8 launches a step of the path's kernels and none of the others, got {per_step}")
    if mixed:
        return os.path.join(cfg.log_dir, f"step_{A_STEPS}"), fwd, bwd, fused
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
    return os.path.join(cfg.log_dir, "best"), fwd, bwd, fused


def step_card_vs_cpu(mixed: bool):
    """Phases 6 and 10: a training step at batch 16 under the profiler, then
    one at batch 2 on the card and on the CPU from the same weights, t and
    noise; in fp32, or in bf16 with ``mixed``."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers import diffusion as D
    from tedm_tpu_torch.trainers.common import make_optimizer, to_nchw

    cfg = config_from_args(["--experiment", "img_only", "--synthetic_data", "--seed", str(SEED),
                            "--log_dir", os.path.join(tempfile.gettempdir(), "unused")]
                           + (["--mixed_precision"] if mixed else []))
    label = "bf16 " if mixed else ""
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
    profile(f"one {label}training step at batch 16",
            lambda: steps.train_step(*args, t=t.cuda(), noise=noise.cuda()))
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
    loss_tol, grad_tol = (BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL) if mixed else (STEP_LOSS_TOL, STEP_GRAD_TOL)
    print(f"{label}training step at batch 2, card vs CPU plain path: loss {loss_g:.6f} vs {loss_c:.6f} "
          f"(relative {loss_err:.2e}, tol {loss_tol}); gradients of {len(grad_errs)} tensors, worst "
          f"relative to the tensor's largest entry {grad_errs[worst]:.2e} at {worst} (tol {grad_tol}), "
          f"median {statistics.median(grad_errs.values()):.2e}", flush=True)
    if not (math.isfinite(loss_g) and loss_err <= loss_tol and grad_errs[worst] <= grad_tol):
        fail(f"the {label}training step on the card disagrees with the CPU plain path")


def train_head(la, ab, tmp, backbone, mixed: bool):
    """Phases 7 and 11: path (b) on a backbone of path (a), then one request
    served from its best checkpoint; in fp32, or in bf16 with ``mixed``.
    Returns the launches of its training run: of the linear-attention
    forward in fp32, of the fused block in bf16."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.serve.app import Predictor
    from tedm_tpu_torch.train import main as train_main

    label = "bf16 path (b)" if mixed else "path (b)"
    logs = os.path.join(tmp, "train_bf16" if mixed else "train", "logs")
    argv = ["--experiment", "TEDM", "--n_labelled_images", "1", "--synthetic_data",
            "--saved_diffusion_model", backbone, "--max_steps", str(B_STEPS),
            "--val_freq", str(B_STEPS), "--log_freq", "1", "--seed", str(SEED),
            "--log_dir", os.path.join(logs, "run_b")] + (["--mixed_precision"] if mixed else [])
    cfg = config_from_args(argv)
    reset_launches(la, ab)
    t0 = time.perf_counter()
    train_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd, fused = read_launches(la, ab)

    recs = read_metrics(cfg.log_dir)
    steps = [r for r in recs if "train/loss" in r]
    val = [r for r in recs if "val/dice" in r]
    step_ms = [1e3 * r["train/imgs_per_sec"] ** -1 for r in steps]
    print(f"{label}: {len(steps)} steps of 1 image x 8 timesteps, {wall:.1f} s wall with "
          f"validation; median step {statistics.median(step_ms[1:]):.3f} ms; losses "
          f"{steps[0]['train/loss']:.4f} .. {steps[-1]['train/loss']:.4f}; val {val}; "
          f"linear_attention launches: forward {fwd}, backward {bwd}; prenorm_linear_attention "
          f"launches {fused}", flush=True)
    # one UNet call of 8 timesteps per step and per val batch (25 images, 2 batches)
    calls = 8 * (B_STEPS + 2)
    if len(steps) != B_STEPS or len(val) != 1 or (fwd, bwd, fused) != ((0, 0, calls) if mixed else (calls, 0, 0)):
        fail(f"{label}: {len(steps)} steps, val {val}, launches {fwd} / {bwd} / {fused}")
    if not all(math.isfinite(v) for v in val[0].values()):
        fail(f"{label}: val metrics {val[0]}")

    mask = Predictor(logs_root=logs, device="cuda").predict(
        np.random.RandomState(SEED).rand(1, cfg.img_size, cfg.img_size, 1).astype(np.float32), "TEDM", 1)
    if mask.shape != (cfg.img_size, cfg.img_size) or not set(np.unique(mask)) <= {0.0, 1.0}:
        fail(f"{label}: served mask of shape {mask.shape}")
    print(f"{label}: served one request from {cfg.log_dir}/best, mask foreground {mask.mean():.4f}")
    return fused if mixed else fwd


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the port on a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tedm_tpu_torch.kernels import _build
    from tedm_tpu_torch.kernels import attn_block as ab
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
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

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
        block_rows = check_block(ab, gen)

    with tempfile.TemporaryDirectory() as tmp:
        with Phase("4. serving path"):
            serve_fwd = serve(la, ab, tmp, mixed=False)
        with Phase("5. training path (a): backbone"):
            backbone, a_fwd, a_bwd, _ = train_backbone(la, ab, tmp, mixed=False)
        with Phase("6. training step: profile, card vs CPU"):
            step_card_vs_cpu(mixed=False)
        with Phase("7. training path (b): TEDM head"):
            b_fwd = train_head(la, ab, tmp, backbone, mixed=False)
        with Phase("8. bf16 serving path"):
            serve_fused = serve(la, ab, tmp, mixed=True)
        with Phase("9. bf16 training path (a): backbone"):
            backbone16, _, _, a_fused = train_backbone(la, ab, tmp, mixed=True)
        with Phase("10. bf16 training step: profile, card vs CPU"):
            step_card_vs_cpu(mixed=True)
        with Phase("11. bf16 training path (b): TEDM head"):
            b_fused = train_head(la, ab, tmp, backbone16, mixed=True)

    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "source": "tedm_tpu_torch/kernels/csrc/linear_attention.cu",
        "replaces": "tedm_tpu/ops/pallas/linear_attention.py:122",
        "launches": serve_fwd + a_fwd + b_fwd,
        "launches_by_path": {"serving": serve_fwd, "training (a)": a_fwd, "training (b)": b_fwd},
        "max_abs_err": max(r["max_abs_err"] for r in fwd_rows.values()),
        # times and bound of one serving request's 8 calls
        **calls_sum(fwd_rows, 2 * SERVE_SHAPES),  # each shape down and up
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in fwd_rows.values()) else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
        "train_step": calls_sum(fwd_rows, 2 * TRAIN_SHAPES),
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
        **calls_sum(bwd_rows, 2 * TRAIN_SHAPES),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bwd_rows.values()) else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
        "per_shape": list(bwd_rows.values()),
    }, {
        "name": "prenorm_linear_attention",
        "route": "cuda",
        "source": "tedm_tpu_torch/kernels/csrc/attn_block.cu",
        "replaces": "tedm_tpu/ops/pallas/attn_block.py:136",
        "launches": serve_fused + a_fused + b_fused,
        "launches_by_path": {"bf16 serving": serve_fused, "bf16 training (a)": a_fused,
                             "bf16 training (b)": b_fused},
        "max_abs_err": max(r["max_abs_err"] for r in block_rows.values()),
        # the least that a control (the plain version with a stage altered) read
        "min_control_err": min(r["min_control_err"] for r in block_rows.values()),
        # times and bound of one bf16 serving request's 8 calls
        **calls_sum(block_rows, block_shapes(8)),
        # what bounds the call that bounds the request most
        "bound_by": max((block_rows[sh] for sh in block_shapes(8)), key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,  # no single PyTorch call computes the block
        "train_step": calls_sum(block_rows, block_shapes(16)),
        "per_shape": [r for r in block_rows.values() if "ms" in r],
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
