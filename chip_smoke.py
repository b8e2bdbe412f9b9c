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
     shapes, with the forward's saved context and statistics vs plain, the
     forward's launches a call (one cluster launch or two, by its route)
     named and timed apart at each of its 8 path shapes, and the backward's
     two launches a call at (16, 4, 32, 16384) and (16, 4, 32, 256); the
     fused PreNorm linear-attention block (bf16) vs plain at
     the serving and training shapes and at edges, on inputs where every
     stage of the attention moves the output, with controls (the plain
     version with a stage altered) that must read above the tolerance, and
     each launch of a serving call timed apart (median under
     torch.profiler);
     the GroupNorm+FiLM+SiLU, ResnetBlock and flash cosine-attention
     kernels vs plain at every call shape of the default UNet at batch 8
     and 16, in fp32 and bf16, and at edges, each with its controls (the
     GroupNorm's edges on both of its routes, its cluster route one launch
     a call, each launch timed apart at (8, 64, 128^2) and (8, 512, 16^2));
     device times (CUDA events) beside each kernel's bound; each launch of
     one ResnetBlock call at (8, 64->64, 128^2) and (16, 768->512, 16^2) and
     of one flash call at (8, 4, 32, 256) timed apart under torch.profiler;
     the ResnetBlock's 1x1 residual conv at every residual call shape
     by the kernel the path takes and by conv_tc (x one element off), each
     held against the plain version and timed; the ResnetBlock's backward
     kernels at every call shape of a training step in fp32 and bf16 and at
     edges, against the plain backward on the same saved tensors and
     autograd of the plain block, with controls, timed beside the flag-off
     block's cuDNN backward;
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
 12. opt-in serving: phase 4's weights served from configs that set
     ``--use_pallas_groupnorm --use_pallas_flash`` (38 GroupNorm and 1
     flash launches a request) and ``--use_pallas_resblock
     --use_pallas_flash`` (19 ResnetBlock and 1 flash launches, no
     GroupNorm), each in fp32 and bf16, against the CPU plain path of the
     same config, and against the flag-off request of phases 4 and 8; the
     ResnetBlock's tensor-core weight layouts are built in the first
     request only;
 13. opt-in training: backbone steps at batch 16 with ``--use_pallas_resblock
     --use_pallas_flash`` in fp32 and bf16 (19 ResnetBlock forward and 19
     backward launches a step), each with a profiled step and a batch-2
     step against the CPU plain path, and TEDM head steps with
     ``--use_pallas_groupnorm``;
then one JSON line listing every kernel and the final JSON status line.
"""

from __future__ import annotations

import collections
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

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
OPT_IN_STEPS = 8               # backbone steps of each opt-in training run
HEAD_STEPS = 2                 # TEDM head steps with --use_pallas_groupnorm
GN, RB, FA = "fused_group_norm_film_silu", "fused_resnet_block", "flash_cosine_attention"
RBB = "fused_resnet_block_backward"
KERNELS = ("linear_attention", "linear_attention_backward", "prenorm_linear_attention", GN, RB, RBB, FA)
# B.4's backward against its plain version, relative to each gradient's
# largest entry: fp32 at KERNELS.json's VJP tolerance; bf16 at the bf16 step
# gate (the data gradients are rounded to bf16 from sums in another order)
RB_BWD_TOL = {torch.float32: LA_BWD_TOL, torch.bfloat16: BF16_STEP_GRAD_TOL}


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
    ("linear_attention forward kernel", ("la_cluster", "context_chunks", "apply_chunks")),
    ("linear_attention backward kernel", ("grad_q", "grad_kv")),
    ("prenorm_linear_attention kernel", ("kv_context", "apply_block")),
    ("fused_group_norm_film_silu kernel", ("gn_cluster", "gn_partials", "gn_apply")),
    ("fused_resnet_block kernel", ("conv_tc", "res_tc", "gn_coefs", "finish_identity")),
    ("fused_resnet_block backward kernel", ("gn_bwd_reduce", "gn_bwd_coefs", "gn_bwd_apply")),
    ("flash_cosine_attention kernel", ("row_norms", "flash_fwd", "flash_row")),
    ("convolution / gemm", ("conv", "cudnn", "xmma", "gemm", "fft", "dgrad", "wgrad",
                            "pointwise_mult_and_sum_complex")),
    ("optimizer / EMA (foreach)", ("multi_tensor", "foreach")),
    ("reduction / softmax / norm", ("reduce", "softmax", "norm")),
    ("elementwise / copy", ("elementwise", "copy", "cat", "index", "fill")),
)


def profile(label: str, fn) -> list:
    """One call of ``fn`` under torch.profiler: device time by kind of
    kernel and by kernel, and the share of the wall time the card was busy.
    The profiler's own overhead inflates the wall time, so the busy share
    is a lower bound. Returns the profile's events, summed by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    for _ in range(3):  # a profiler session now and then returns no device events: ask again
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
        if busy_ms > 0:
            break
    else:
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
    return list(prof.key_averages())


def call_launches(label: str, fn, calls: int = 10) -> list:
    """[name, median device ms] of each kernel that one call of ``fn``
    launches, in launch order, after a warm-up call: ``calls`` calls in one
    torch.profiler session, each after a spin kernel that marks where it
    starts, and the launches that most calls show (at least half of them),
    each timed by its median over those calls. A session can lose device
    events (the first of a session, seen twice in a row on an H100 with
    torch 2.11, or some at random); a call that lost one shows other
    launches and is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)  # absorbs the loss of a session's first event
            torch.cuda.synchronize()
            for _ in range(calls):
                torch.cuda._sleep(100)
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
                        key=lambda e: e.time_range.start)
        per_call, current = [], None
        for e in events:
            if "spin_kernel" in e.name:
                if current:
                    per_call.append(current)
                current = []
            elif current is not None:
                current.append(e)
        if current:
            per_call.append(current)
        lists = collections.Counter(tuple(e.name for e in c) for c in per_call)
        if lists:
            names, n = lists.most_common(1)[0]
            if n >= calls // 2:
                chosen = [c for c in per_call if tuple(e.name for e in c) == names]
                return [[name, statistics.median(c[i].time_range.elapsed_us() / 1e3 for c in chosen)]
                        for i, name in enumerate(names)]
    fail(f"{label}: no list of launches in half of {calls} calls, in 3 profiler sessions")


def launch_profile(label: str, fn, calls: int = 10) -> list:
    """Each device kernel that a call of ``fn`` launches, in launch order,
    with its median device ms (``call_launches``), printed beside their sum.
    Returns [name, ms] per launch."""
    rows = call_launches(label, fn, calls)
    print(f"launches of {label}: {len(rows)}, device ms summed {sum(ms for _, ms in rows):.4f}", flush=True)
    for name, ms in rows:
        print(f"  {ms:9.4f} ms  {name[:110]}", flush=True)
    return rows


def short_name(kernel: str) -> str:
    """A device kernel's function name without namespace, template or arguments."""
    found = re.findall(r"::(\w+)", kernel)
    return found[0] if found else kernel[:40]


def read_metrics(run_dir: str) -> list:
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def forward_launches(la, shape) -> list:
    """The CUDA kernels one forward call launches at ``shape`` by the
    kernel's route: one cluster launch, or two launches."""
    b, h, _, n = shape
    return ["la_cluster"] if la.forward_route(b * h, n) else ["context_chunks", "apply_chunks"]


def check_forward(la, gen, scale):
    """Forward kernel vs plain at the serving and training shapes and at
    edges; per-shape rows with times, and each launch of a call at every
    shape timed apart under torch.profiler, which must be the launches of
    the kernel's route, by name; a row's ``cuda_launches`` is their count."""
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
            # each launch of a call, median over calls
            "per_launch": call_launches(f"linear_attention {shape}", lambda: la.linear_attention(q, k, v, scale),
                                        REPS),
        }
        if [short_name(name) for name, _ in row["per_launch"]] != forward_launches(la, shape):
            fail(f"linear_attention {shape} launched {[name for name, _ in row['per_launch']]}, "
                 f"not {forward_launches(la, shape)}")
        row["cuda_launches"] = len(row["per_launch"])
        rows[shape] = row
        split = "".join(f", {short_name(name)} {ms:.4f}" for name, ms in row["per_launch"])
        print(f"linear_attention {shape}: max_abs_err {err:.3e} (|ref| <= {row['max_abs_ref']:.3f}, "
              f"tol {LA_TOL}) kernel {row['ms']:.4f} ms{split} plain {row['plain_ms']:.4f} ms "
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
    the edges, on the forward kernel's saved scale*C and statistics, which
    are held against their plain version first; per-shape rows with times,
    and the two launches of a call timed apart at N = 16384 and 256."""
    from tedm_tpu_torch.kernels.bounds import bound, linear_attention_backward_call

    rows = {}
    cases = [(s, *(torch.randn(s, generator=gen, device="cuda") * 2 for _ in range(2)),
              torch.randn(s, generator=gen, device="cuda") * s[-1]) for s in TRAIN_SHAPES]
    for i, (what, q, k, v) in enumerate(cases + list(edge_inputs(gen))):
        g = torch.randn(q.shape, generator=gen, device="cuda")
        if what == "qkv views":  # a gradient with a batch stride of its own
            g = torch.randn(2, 3 * 128, 400, generator=gen, device="cuda")[:, 128:256].reshape(2, 4, 32, 400)
        _, ctx, stats = la._forward(q, k, v, scale)
        saved = la.linear_attention_saved_reference(q, k, v, scale)
        got = la._backward(q, k, v, g, ctx, stats, scale)
        ref = la.linear_attention_backward_reference(q, k, v, g, scale)
        torch.cuda.synchronize()
        saved_errs = [rel_err(ctx, saved[0]), rel_err(stats[:, 0], saved[1][:, 0]), rel_err(stats[:, 1], saved[1][:, 1])]
        if not max(saved_errs) <= LA_TOL:
            fail(f"linear_attention forward's saved scale*C, m, l disagree with their plain version at {what}: "
                 f"{saved_errs}")
        errs = [rel_err(a, b) for a, b in zip(got, ref)]
        if not max(errs) <= LA_BWD_TOL:
            fail(f"linear_attention backward disagrees with its plain version at {what}: "
                 f"relative errors (dq, dk, dv) {errs}")
        if i >= len(cases):
            continue
        shape = tuple(q.shape)
        b, h, d, n = shape
        row = {
            "shape": list(shape),
            "max_abs_err": max((a - r).abs().max().item() for a, r in zip(got, ref)),
            "max_rel_err": max(errs),
            "saved_rel_err": max(saved_errs),
            "ms": device_ms(lambda: la._backward(q, k, v, g, ctx, stats, scale)),
            "plain_ms": device_ms(lambda: la.linear_attention_backward_reference(q, k, v, g, scale)),
            **bound(*linear_attention_backward_call(b, n)),
        }
        if n in (256, 16384):  # each launch of a call, median over calls; two a call
            row["per_launch"] = call_launches(f"linear_attention backward {shape}",
                                              lambda: la._backward(q, k, v, g, ctx, stats, scale), REPS)
            if [short_name(name) for name, _ in row["per_launch"]] != ["grad_q", "grad_kv"]:
                fail(f"linear_attention backward {shape} launched {[name for name, _ in row['per_launch']]}, "
                     "not grad_q and grad_kv")
        rows[shape] = row
        split = "".join(f", {short_name(name)} {ms:.4f}" for name, ms in row.get("per_launch", []))
        print(f"linear_attention backward {shape}: relative errors (dq, dk, dv) "
              f"{', '.join(f'{e:.2e}' for e in errs)} (tol {LA_BWD_TOL}; saved {max(saved_errs):.2e}) kernel "
              f"{row['ms']:.4f} ms{split} plain {row['plain_ms']:.4f} ms bound {1e3 * row['bound_ms']:.2f} us",
              flush=True)
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
    from tedm_tpu_torch.kernels.bounds import bound, prenorm_attention_call

    rows = {}
    with torch.no_grad():
        for shape in block_shapes(8) + block_shapes(16):
            if shape in rows:  # the up and down paths share shapes
                continue
            b, c, n = shape
            args = block_inputs(gen, b, c, n)
            err, control = block_errors(ab, args, shape)
            row = {
                "shape": list(shape),
                "max_abs_err": err,
                "min_control_err": control,
                "ms": device_ms(lambda: ab.prenorm_linear_attention(*args)),
                "plain_ms": device_ms(lambda: ab.prenorm_linear_attention_reference(*args)),
                **bound(*prenorm_attention_call(b, c, n)),
            }
            if b == 8:  # each launch of a serving call, median over calls
                row["per_launch"] = call_launches(f"prenorm_linear_attention {shape}",
                                                  lambda: ab.prenorm_linear_attention(*args), REPS)
            rows[shape] = row
            split = "".join(f", {short_name(name)} {ms:.4f}" for name, ms in row.get("per_launch", []))
            print(f"prenorm_linear_attention {shape}: max_abs_err {err:.3e} (tol {BLOCK_TOL}; controls "
                  f">= {control:.3f}) kernel {row['ms']:.4f} ms{split} plain {row['plain_ms']:.4f} ms bound "
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


def calls_sum(rows, keys) -> dict:
    """Times and bound summed over calls, one a key as listed, with the
    flag-off block's and the library call's times where the rows have them."""
    return {k: sum(rows[key][k] for key in keys)
            for k in ("ms", "plain_ms", "bound_ms", "default_ms", "recompute_ms", "library_ms") if k in rows[keys[0]]}


def gate(dtype) -> float:
    """The forward gate of KERNELS.json: 2e-5 in fp32, 5e-2 in bf16, absolute."""
    return BLOCK_TOL if dtype == torch.bfloat16 else LA_TOL


def held(name, out, ref, controls, what, dtype) -> tuple:
    """The kernel's output against its plain version, and against each
    control (the plain version with one stage altered), which it must differ
    from by more than the gate. Returns (error, least control reading)."""
    tol = gate(dtype)
    err = (out.float() - ref.float()).abs().max().item()
    if not err <= tol:
        fail(f"{name} kernel disagrees with its plain version at {what}: {err} (tol {tol})")
    reads = {}
    for cname, control in controls.items():
        reads[cname] = (out.float() - control.float()).abs().max().item()
        if not reads[cname] > tol:
            fail(f"{name} check at {what} cannot see its {cname} control: {reads[cname]}")
    return err, min(reads.values(), default=float("inf"))


def dtype_name(dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "fp32"


# ------------------------------------------------------------------ B.3

def gn_calls(batch: int) -> list:
    """((B, C, H, W), FiLM?) of the default UNet's 38 GroupNorms, in call
    order: two per ResnetBlock, of its output width, the first with FiLM."""
    from tedm_tpu_torch.kernels.bounds import unet_stages

    return [((batch, c_out, s, s), film) for _, c_out, s in unet_stages()[1] for film in (True, False)]


def gn_inputs(gen, shape, dtype, film, strided=False):
    """x whose channels and groups differ in mean and spread, as a conv's
    output does (group means +-3 in turn, so that the control below reads
    far above the gate), gamma and beta, and FiLM rows as the strided
    halves of one (B, 2C) tensor, as the time MLP gives them. With
    ``strided``, x is the middle third of a (B, 3C, H, W) tensor: a batch
    stride of its own. Gains and FiLM keep |out| below 4, where one bf16
    ulp is 1.56e-2 at most."""
    b, c = shape[:2]
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    offset = torch.tensor([3.0, -3.0] * 4, device="cuda").repeat_interleave(c // 8).reshape(1, c, 1, 1)
    x = (r(*shape) * (1 + r(1, c, 1, 1).abs()) + 0.3 * r(1, c, 1, 1) + offset).to(dtype)
    if strided:
        x = torch.cat([r(*shape).to(dtype), x, r(*shape).to(dtype)], dim=1)[:, c:2 * c]
    scale, shift = (0.15 * r(b, 2 * c)).to(dtype).chunk(2, dim=1) if film else (None, None)
    return x, 0.35 * (1 + 0.1 * r(c)), 0.1 * r(c), scale, shift


def gn_check(gn, args, what, route=None):
    """The kernel against its plain version and the control: group 0's
    statistics taken over the wrong span, one group on (group 1's). The
    kernel on ``route`` where one is given, else on its own."""
    x = args[0]
    mean, rstd = gn.group_stats(x)
    mean, rstd = mean.clone(), rstd.clone()
    mean[:, 0], rstd[:, 0] = mean[:, 1], rstd[:, 1]
    controls = {"group 0 over a wrong span": gn.group_norm_film_silu_reference(*args, stats=(mean, rstd))}
    out = gn.fused_group_norm_film_silu(*args) if route is None else gn._forward(*args, 8, 1e-5, route=route)
    return held("fused_group_norm_film_silu", out, gn.group_norm_film_silu_reference(*args), controls, what, x.dtype)


def gn_routes(gn, args) -> list:
    """Both routes for the call: the cluster route (the path's size, else 8
    CTAs where they fit) and the two passes."""
    x = args[0]
    b, c, h, w = x.shape
    path = gn.device_route(x, x.dtype == torch.bfloat16 and args[3] is not None)
    cluster = path if path.cluster else gn.Route(8, gn.cluster_smem(c, h * w, x.element_size(), 8))
    return [r for r in (cluster, gn.TWO_PASS) if r.smem <= gn.SMEM_PER_CTA]


def check_groupnorm(gn, gen):
    """B.3 against its plain version at every call shape of the default UNet
    at batch 8 and 16, in fp32 and bf16, with and without FiLM, and at
    edges on both routes; per-call rows with times and the route taken; one
    launch a call on the cluster route, and each launch of a call timed
    apart on both routes at (8, 64, 128^2) and (8, 512, 16^2)."""
    from tedm_tpu_torch.kernels.bounds import bound, groupnorm_call

    rows = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for shape, film in dict.fromkeys(gn_calls(8) + gn_calls(16)):
                args = gn_inputs(gen, shape, dtype, film)
                err, control = gn_check(gn, args, (shape, dtype, film))
                b, c, h, w = shape
                row = {"shape": list(shape), "dtype": dtype_name(dtype), "film": film, "max_abs_err": err,
                       "min_control_err": control, "cluster": gn_routes(gn, args)[0].cluster,
                       "ms": device_ms(lambda: gn.fused_group_norm_film_silu(*args)),
                       "plain_ms": device_ms(lambda: gn.group_norm_film_silu_reference(*args)),
                       **bound(*groupnorm_call(b, c, h * w, args[0].element_size()))}
                if film and shape in [(8, 64, 128, 128), (8, 512, 16, 16)]:
                    label = f"fused_group_norm_film_silu {shape} {dtype_name(dtype)}"
                    row["per_launch"] = launch_profile(label, lambda: gn.fused_group_norm_film_silu(*args))
                    if [short_name(name) for name, _ in row["per_launch"]] != ["gn_cluster"]:
                        fail(f"{label} launched {[name for name, _ in row['per_launch']]}, not one gn_cluster")
                    row["two_pass_per_launch"] = launch_profile(
                        f"{label} on the two-pass route", lambda: gn._forward(*args, 8, 1e-5, route=gn.TWO_PASS))
                rows[(shape, dtype, film)] = row
                print(f"fused_group_norm_film_silu {shape} {row['dtype']} film={film}: max_abs_err {err:.3e} "
                      f"(controls >= {control:.3f}) cluster {row['cluster']} kernel {row['ms']:.4f} ms plain "
                      f"{row['plain_ms']:.4f} ms bound {1e3 * row['bound_ms']:.2f} us", flush=True)
                del args
            edges = [(s, f) for s in [(1, 64, 1, 1), (3, 16, 1, 17), (1, 64, 15, 17), (3, 32, 8, 12), (1, 16, 8, 12),
                                      (1, 64, 256, 256)] for f in (True, False)]
            cases = [(gn_inputs(gen, shape, dtype, film), (shape, dtype, film)) for shape, film in edges]
            cases.append((gn_inputs(gen, (2, 64, 12, 8), dtype, True, strided=True), "x with a batch stride"))
            if cases[-1][0][0].is_contiguous():
                fail("the strided-x check got a contiguous x")
            for args, what in cases:
                for route in gn_routes(gn, args):
                    gn_check(gn, args, (what, route.cluster), route)
                gn_check(gn, args, (what, "path"))
            del cases
    print("fused_group_norm_film_silu edges (N = 1, 17, 255; 8x12; C = 16; B = 1, 3; a 256^2 slab; a strided x) "
          "on both routes, and strided FiLM rows: within tolerance", flush=True)
    return rows


# ------------------------------------------------------------------ B.4

def rb_shapes(batch: int) -> list:
    """(B, Cin, Cout, H, W) of the default UNet's 19 ResnetBlocks, in call order."""
    from tedm_tpu_torch.kernels.bounds import unet_stages

    return [(batch, c_in, c_out, s, s) for c_in, c_out, s in unet_stages()[1]]


def rb_inputs(gen, shape, dtype, film=True, x=None):
    """x and the block's fp32 parameters at a conv's scale (weights of
    variance 1 / fan_in), FiLM rows as strided halves. GN1's shift at 0.5
    moves SiLU(GN1(0)) well off 0, so that the conv2-padding control reads
    far above the gate. x at 0.2 and GN2's gain at 0.4 keep |out| below 4,
    where one bf16 ulp is 1.56e-2 at most."""
    b, cin, cout, h, w = shape
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    if x is None:
        x = 0.2 * r(b, cin, h, w)
    res = cin != cout
    scale, shift = (0.5 * r(b, 2 * cout)).to(dtype).chunk(2, dim=1) if film else (None, None)
    return (x.to(dtype), r(cout, cin, 3, 3) * (9 * cin) ** -0.5, 0.1 * r(cout), 1 + 0.1 * r(cout), 0.5 * r(cout),
            scale, shift, r(cout, cout, 3, 3) * (9 * cout) ** -0.5, 0.1 * r(cout), 0.4 * (1 + 0.1 * r(cout)),
            0.04 * r(cout), r(cout, cin, 1, 1) * cin ** -0.5 if res else None, 0.1 * r(cout) if res else None)


def rb_check(rb, args, what):
    """The kernel against its plain version and the controls: FiLM dropped,
    the 3x3 taps flipped left-right (not on a one-column image, where only
    the centre tap reads), and conv2's zero padding replaced by GN1+SiLU of
    0, the likeliest bug of a normalising prologue, seen at the borders.
    Each must read above the gate."""
    ref = rb.resnet_block_reference
    controls = {"conv2 pads after GN1+SiLU": ref(*args, pad_after_norm=True)}
    if args[5] is not None:
        controls["FiLM dropped"] = ref(*args[:5], None, None, *args[7:])
    if args[0].shape[-1] > 1:
        flipped = list(args)
        flipped[1], flipped[7] = args[1].flip(-1), args[7].flip(-1)
        controls["taps flipped"] = ref(*flipped)
    return held("fused_resnet_block", rb.fused_resnet_block(*args), ref(*args), controls, what, args[0].dtype)


def default_block(args):
    """The port's flag-off ResnetBlock (no time MLP) on the same weights and
    FiLM rows, in x's dtype: a thunk of its forward (``.module`` the block)."""
    from tedm_tpu_torch.models.unet import ResnetBlock

    x, w1, b1, g1, be1, scale, shift, w2, b2, g2, be2, wres, bres = args
    m = ResnetBlock(w1.shape[1], w1.shape[0]).cuda().eval()
    for mod in m.modules():
        if hasattr(mod, "compute_dtype"):
            mod.compute_dtype = x.dtype
    pairs = [(m.block1.proj.weight, w1), (m.block1.proj.bias, b1), (m.block1.norm.weight, g1), (m.block1.norm.bias, be1),
             (m.block2.proj.weight, w2), (m.block2.proj.bias, b2), (m.block2.norm.weight, g2), (m.block2.norm.bias, be2)]
    if wres is not None:
        pairs += [(m.res_conv.weight, wres), (m.res_conv.bias, bres)]
    for p, v in pairs:
        p.data.copy_(v)
    ss = None if scale is None else (scale, shift)
    forward = lambda: m.block2(m.block1(x, ss)) + m.res_conv(x)
    forward.module = m
    return forward


def residual_routes(rb, gen) -> list:
    """The residual 1x1 conv at every residual call shape of the default
    UNet (batch 8 and 16) in each dtype, by the kernel the path takes
    (res_tc in bf16 and from 64^2 up in fp32, which needs x's rows 16-byte
    aligned; else conv_tc<T, 1, RESIDUAL>) and by conv_tc, taken when x
    starts one element off. Each is held against the plain version; each
    row gives the residual launch's median device ms by either route."""
    rows = []
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in dict.fromkeys(s for s in rb_shapes(8) + rb_shapes(16) if s[1] != s[2]):
                args = rb_inputs(gen, shape, dtype)
                x = args[0]
                off = torch.empty(x.numel() + 1, device="cuda", dtype=dtype)[1:].view(x.shape)
                off.copy_(x)
                want = "res_tc" if dtype == torch.bfloat16 or shape[3] * shape[4] >= 64 * 64 else "conv_tc"
                row = {"shape": list(shape), "dtype": dtype_name(dtype), "path_kernel": want}
                for key, xs, kernel in (("path", x, want), ("conv_tc", off, "conv_tc")):
                    rb_check(rb, (xs,) + args[1:], (shape, dtype, key))
                    name, row[f"{key}_ms"] = call_launches(f"fused_resnet_block {shape} {row['dtype']} x {key}",
                                                           lambda: rb.fused_resnet_block(xs, *args[1:]), REPS)[-1]
                    if kernel not in name:
                        fail(f"fused_resnet_block {shape} {dtype_name(dtype)} with x {key} ended in {name}, not {kernel}")
                rows.append(row)
                print(f"fused_resnet_block residual {shape} {row['dtype']}: path ({want}) {row['path_ms']:.4f} ms, "
                      f"conv_tc {row['conv_tc_ms']:.4f} ms", flush=True)
                del args, x, off
    return rows


def check_resblock(rb, gen):
    """B.4 against its plain version at every call shape of the default UNet
    at batch 8 and 16, in fp32 and bf16, and at edges; per-call rows with the
    kernel's, the plain version's and the flag-off block's times, and the
    launches of one call at two shapes timed apart."""
    from tedm_tpu_torch.kernels.bounds import bound, resblock_call

    rows, per_launch = {}, {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for shape in dict.fromkeys(rb_shapes(8) + rb_shapes(16)):
                args = rb_inputs(gen, shape, dtype)
                err, control = rb_check(rb, args, (shape, dtype))
                b, cin, cout, h, w = shape
                row = {"shape": list(shape), "dtype": dtype_name(dtype), "max_abs_err": err, "min_control_err": control,
                       "ms": device_ms(lambda: rb.fused_resnet_block(*args)),
                       "plain_ms": device_ms(lambda: rb.resnet_block_reference(*args)),
                       "default_ms": device_ms(default_block(args)),
                       **bound(*resblock_call(b, cin, cout, h * w, args[0].element_size()))}
                rows[(shape, dtype)] = row
                print(f"fused_resnet_block {shape} {row['dtype']}: max_abs_err {err:.3e} (controls >= {control:.3f}) "
                      f"kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms flag-off block "
                      f"{row['default_ms']:.4f} ms bound {1e3 * row['bound_ms']:.2f} us ({row['bound_by']})", flush=True)
                del args
            edges = [((1, 64, 64, 1, 1), True), ((3, 16, 24, 1, 17), True), ((1, 32, 16, 15, 17), True),
                     ((3, 16, 16, 8, 12), True), ((1, 64, 64, 8, 12), False), ((2, 24, 16, 8, 12), False)]
            for shape, film in edges:
                rb_check(rb, rb_inputs(gen, shape, dtype, film), (shape, dtype, film))
            wide = (0.2 * torch.randn(2, 3 * 64, 12, 8, generator=gen, device="cuda")).to(dtype)
            rb_check(rb, rb_inputs(gen, (2, 64, 64, 12, 8), dtype, x=wide[:, 64:128]), "x with a batch stride")
            # each launch of one call: the widest plane and the deepest K
            for shape in [(8, 64, 64, 128, 128), (16, 768, 512, 16, 16)]:
                args = rb_inputs(gen, shape, dtype)
                per_launch[f"{shape} {dtype_name(dtype)}"] = launches_of = launch_profile(
                    f"fused_resnet_block {shape} {dtype_name(dtype)}", lambda: rb.fused_resnet_block(*args))
                convs = sum(any(k in name for k in ("conv_tc", "res_tc")) for name, _ in launches_of)
                if convs != (2 if shape[1] == shape[2] else 3):
                    fail(f"fused_resnet_block {shape} made {convs} tensor-core conv launches")
                del args
    print("fused_resnet_block edges (N = 1, 17, 255; 8x12; C = 16; B = 1, 3; no FiLM; identity and 1x1 "
          "residual; a strided x): within tolerance", flush=True)
    return rows, per_launch, residual_routes(rb, gen)


def rb_backward_errors(got, want) -> float:
    """The largest error of any gradient present in both, relative to that
    gradient's largest entry. Both have the same gradients, or the
    ``want`` of a control has fewer."""
    if any(a is None and b is not None for a, b in zip(got, want)):
        fail(f"a backward gave no gradient where its plain version gives one: {[a is None for a in got]}")
    return max(rel_err(a.float(), b.float()) for a, b in zip(got, want) if a is not None and b is not None)


def default_block_backward(args, dout):
    """The flag-off ResnetBlock's cuDNN backward on the same weights: a thunk
    that runs it once over one retained forward graph."""
    x = args[0].detach().requires_grad_()
    forward = default_block((x,) + tuple(args[1:]))
    with torch.enable_grad():
        out = forward()
    params = [x, *forward.module.parameters()]
    return lambda: torch.autograd.grad(out, params, dout, retain_graph=True)


def plain_recompute(rb, args, dout):
    """The block's earlier backward: the plain block recomputed under
    autograd and differentiated, as a thunk."""
    def run():
        leaves = [None if t is None else t.detach().requires_grad_() for t in args]
        with torch.enable_grad():
            out = rb.resnet_block_reference(*leaves)
            return torch.autograd.grad(out, [t for t in leaves if t is not None], dout)
    return run


def check_resblock_backward(rb, gen):
    """B.4's backward kernels (from the saved h1, h2 and statistics of the
    kernel's own forward) against their plain version on the same saved
    tensors and against autograd of the plain block, at the 19 call shapes
    of a training step (batch 16) in fp32 and bf16 and at edges, with its
    controls (conv2's weight gradient over h1n padded after GN1+SiLU; GN1's
    backward without FiLM); per-call rows with the kernel's, the plain
    version's, the plain recompute's (the earlier backward) and the flag-off
    block's cuDNN backward's times; and the launches of one backward at two
    shapes."""
    from tedm_tpu_torch.kernels.bounds import bound, resblock_backward_call

    rows, per_launch = {}, {}
    everything = (True,) * 13
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            tol = RB_BWD_TOL[dtype]
            cases = [(s, True) for s in dict.fromkeys(rb_shapes(16))]
            cases += [((1, 64, 64, 1, 1), True), ((3, 16, 24, 1, 17), True), ((1, 32, 16, 15, 17), True),
                      ((3, 16, 16, 8, 12), False), ((2, 24, 16, 8, 12), False)]
            for shape, film in cases:
                args = rb_inputs(gen, shape, dtype, film)
                b, cin, cout, h, w = shape
                dout = torch.randn(b, cout, h, w, generator=gen, device="cuda").to(dtype)
                _, saved = rb._forward(*args, 8, 1e-5)
                got = rb._backward(*args, saved, dout, 8, everything)
                v = rb.saved_views(saved, b, cout, h, w, 8)
                plain = lambda **kw: rb.resnet_block_backward_reference(*args, v["h1"], v["h2"], dout, **kw)
                want = plain()
                if [g is None for g in got] != [g is None for g in want]:
                    fail(f"fused_resnet_block backward at {shape} gives gradients {[g is not None for g in got]}, "
                         f"its plain version {[g is not None for g in want]}")
                err = rb_backward_errors(got, want)
                with torch.enable_grad():
                    auto = plain_recompute(rb, args, dout)()
                auto_err = rb_backward_errors([g for g, a in zip(got, args) if a is not None], auto)
                what = (shape, dtype_name(dtype), film)
                if not (err <= tol and auto_err <= tol):
                    fail(f"fused_resnet_block backward disagrees with its plain version at {what}: {err}, "
                         f"with autograd of the plain block: {auto_err} (tol {tol})")
                controls = {"conv2's weight gradient over h1n padded after GN1+SiLU": plain(pad_after_norm=True)}
                if film:
                    controls["GN1's backward without FiLM"] = plain(film_dropped=True)
                reads = {k: rb_backward_errors(got, c) for k, c in controls.items()}
                if not min(reads.values()) > tol:
                    fail(f"fused_resnet_block backward check at {what} cannot see a control: {reads}")
                if shape[0] != 16:
                    continue
                row = {"shape": list(shape), "dtype": dtype_name(dtype), "max_abs_err": max(
                           (a.float() - r.float()).abs().max().item() for a, r in zip(got, want) if a is not None),
                       "max_rel_err": err, "autograd_rel_err": auto_err, "min_control_err": min(reads.values()),
                       "ms": device_ms(lambda: rb._backward(*args, saved, dout, 8, everything)),
                       "plain_ms": device_ms(lambda: rb.resnet_block_backward_reference(
                           *args, v["h1"], v["h2"], dout)),
                       "recompute_ms": device_ms(plain_recompute(rb, args, dout)),
                       "library_ms": device_ms(default_block_backward(args, dout)),
                       **bound(*resblock_backward_call(b, cin, cout, h * w, args[0].element_size()))}
                rows[(shape, dtype)] = row
                print(f"fused_resnet_block backward {shape} {row['dtype']}: relative error {err:.3e} (autograd of the "
                      f"plain block {auto_err:.3e}; tol {tol}; controls >= {row['min_control_err']:.3f}) kernel "
                      f"{row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms plain recompute {row['recompute_ms']:.4f} "
                      f"ms flag-off block's cuDNN backward {row['library_ms']:.4f} ms bound "
                      f"{1e3 * row['bound_ms']:.2f} us ({row['bound_by']})", flush=True)
                if shape in [(16, 64, 64, 128, 128), (16, 768, 512, 16, 16)]:
                    label = f"fused_resnet_block backward {shape} {dtype_name(dtype)}"
                    per_launch[label] = launch_profile(label, lambda: rb._backward(*args, saved, dout, 8, everything))
                    mine = sum(any(k in name for k in ("gn_bwd_reduce", "gn_bwd_coefs", "gn_bwd_apply"))
                               for name, _ in per_launch[label])
                    if mine != 6:
                        fail(f"{label} made {mine} GroupNorm backward launches, not 6")
                del args, saved, got, want, v, auto, controls
    print("fused_resnet_block backward edges (N = 1, 17, 255; 8x12; C = 16; B = 1, 3; no FiLM; identity and 1x1 "
          "residual): within tolerance", flush=True)
    return rows, per_launch


# ------------------------------------------------------------------ B.5

def fa_inputs(gen, b, n, dtype):
    """q, k, v as the three chunks of a qkv conv output (B, 3*128, N):
    views with a batch stride of 3*128*N, as the UNet passes them."""
    qkv = torch.randn(b, 3 * 128, n, generator=gen, device="cuda").to(dtype)
    return tuple(t.reshape(b, 4, 32, n) for t in qkv.chunk(3, dim=1))


def check_flash(fa, gen):
    """B.5 against its plain version at the mid stage (N = 256) at batch 8
    and 16, at N = 1024 and 4096 (256^2 and 512^2 inputs) and at edges, in
    fp32 and bf16, with its control (the norms over d instead of N); per-call
    rows with times and the time of F.scaled_dot_product_attention(scale=16)
    on pre-normalised q and k, the library's call for the same function.
    At the path's N = 256 one call is one launch."""
    from tedm_tpu_torch.kernels.bounds import bound, flash_call

    rows, per_launch = {}, {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for b, n in [(8, 256), (16, 256), (8, 1024), (8, 4096), (2, 1), (3, 17), (1, 255)]:
                q, k, v = fa_inputs(gen, b, n, dtype)
                # at N = 1 the output is v whatever the norms: no control can read there
                controls = {"norms over d": fa.cosine_attention_reference(q, k, v, 16.0, norm_dim=2)} if n > 1 else {}
                err, ctl = held("flash_cosine_attention", fa.flash_cosine_attention(q, k, v, 16.0),
                                fa.cosine_attention_reference(q, k, v, 16.0), controls, (b, n, dtype), dtype)
                if b < 8:
                    continue
                qn, kn = (F.normalize(t.float(), dim=-1).to(dtype).transpose(2, 3).contiguous() for t in (q, k))
                vn = v.transpose(2, 3).contiguous()
                row = {"shape": [b, 4, 32, n], "dtype": dtype_name(dtype), "max_abs_err": err, "min_control_err": ctl,
                       "ms": device_ms(lambda: fa.flash_cosine_attention(q, k, v, 16.0)),
                       "plain_ms": device_ms(lambda: fa.cosine_attention_reference(q, k, v, 16.0)),
                       "library_ms": device_ms(lambda: F.scaled_dot_product_attention(qn, kn, vn, scale=16.0)),
                       **bound(*flash_call(b, n, q.element_size()))}
                rows[(b, n, dtype)] = row
                print(f"flash_cosine_attention {(b, 4, 32, n)} {row['dtype']}: max_abs_err {err:.3e} (control "
                      f"{ctl:.3f}) kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms sdpa "
                      f"{row['library_ms']:.4f} ms bound {1e3 * row['bound_ms']:.2f} us", flush=True)
                if (b, n) == (8, 256):
                    label = f"flash_cosine_attention {(b, 4, 32, n)} {row['dtype']}"
                    per_launch[label] = launch_profile(label, lambda: fa.flash_cosine_attention(q, k, v, 16.0))
                    made = sum(any(s in name for s in ("flash_fwd", "flash_row", "row_norms")) for name, _ in per_launch[label])
                    if made != 1:
                        fail(f"{label} made {made} launches, not one")
    print("flash_cosine_attention edges (N = 1, 17, 255; B = 2, 3, 1) on strided q, k, v views: within tolerance",
          flush=True)
    return rows, per_launch


# ------------------------------------------------------------------ launches

def counters() -> dict:
    """Each kernel's launch counter: (its wrapper, the attribute)."""
    from tedm_tpu_torch.kernels import attn_block, flash_attention, groupnorm, linear_attention, resblock

    return {"linear_attention": (linear_attention.linear_attention, "launches"),
            "linear_attention_backward": (linear_attention.linear_attention, "backward_launches"),
            "prenorm_linear_attention": (attn_block.prenorm_linear_attention, "launches"),
            GN: (groupnorm.fused_group_norm_film_silu, "launches"),
            RB: (resblock.fused_resnet_block, "launches"),
            RBB: (resblock.fused_resnet_block, "backward_launches"),
            FA: (flash_attention.flash_cosine_attention, "launches")}


def reset_launches() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in counters().items()}


def launches(**counts) -> dict:
    """A launch count for every kernel, 0 unless given."""
    return {k: counts.get(k, 0) for k in KERNELS}


def per_unet_call(mixed: bool, flags=(), backward: bool = False) -> dict:
    """Launches of one UNet forward (and backward) of the path: 8 linear
    attentions (fp32) or fused blocks (bf16), and the opt-in kernels its
    flags switch on (the ResnetBlock's backward in a backward too);
    ResnetBlock wins over GroupNorm."""
    counts = {"prenorm_linear_attention": 8} if mixed else {"linear_attention": 8}
    if backward and not mixed:
        counts["linear_attention_backward"] = 8
    if "--use_pallas_resblock" in flags:
        counts[RB] = 19
        if backward:
            counts[RBB] = 19
    elif "--use_pallas_groupnorm" in flags:
        counts[GN] = 38
    if "--use_pallas_flash" in flags:
        counts[FA] = 1
    return launches(**counts)


def label_of(mixed: bool, flags=()) -> str:
    return " ".join(["bf16"] * mixed + list(flags)) + (" " if mixed or flags else "")


# ------------------------------------------------------------------ paths

def random_tedm(tmp):
    """The state and config of a TEDM model at the repo's default width,
    random weights from the seed, built on the card."""
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.trainers.datasetdm import build_task

    cfg = Config(log_dir=os.path.join(tmp, "serve", "run")).replace(
        experiment="TEDM", n_labelled_images=1, seed=SEED,
        saved_diffusion_model=os.path.join(tmp, "no_backbone"),
    ).apply_experiment_preset()
    task = build_task(cfg, device="cuda")  # random weights from cfg.seed
    return {"backbone": task.unet.state_dict(), "classifier": task.classifier.state_dict()}, cfg


def serve(tmp, mixed: bool, flags=(), flag_off=None):
    """Phases 4, 8 and 12: the serving path. fp32 without flags: a TEDM model
    with random weights from the seed, saved and served; otherwise the same
    weights under a config with ``mixed_precision`` and the opt-in ``flags``.
    Returns the launches, the probabilities of one request (image 0, fixed
    noise) and the median latency."""
    from tedm_tpu_torch.kernels import resblock as rb
    from tedm_tpu_torch.serve.app import Predictor
    from tedm_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    label = label_of(mixed, flags)
    logs32 = os.path.join(tmp, "serve", "logs")
    if mixed or flags:
        state, cfg = load_checkpoint(os.path.join(logs32, "TEDM", "1", "best"), verbose=False)
        cfg = cfg.replace(mixed_precision=mixed, **{f[2:]: True for f in flags})
        logs = os.path.join(tmp, "serve_" + "_".join(["bf16"] * mixed + [f[13:] for f in flags]), "logs")
    else:
        state, cfg = random_tedm(tmp)
        logs = logs32
    save_checkpoint(os.path.join(logs, "TEDM", "1", "best"), state, cfg)
    del state
    rs = np.random.RandomState(SEED)
    imgs = [rs.rand(1, cfg.img_size, cfg.img_size, 1).astype(np.float32) for _ in range(N_REQUESTS)]
    predictor = Predictor(logs_root=logs, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    latencies, masks, per_request, layouts = [], [], [], []
    for img in imgs:
        before, built = read_launches(), rb.fused_resnet_block.layouts_built
        t0 = time.perf_counter()
        masks.append(predictor.predict(img, "TEDM", 1))  # returns host numpy: synchronised
        latencies.append(1e3 * (time.perf_counter() - t0))
        per_request.append({k: v - before[k] for k, v in read_launches().items()})
        layouts.append(rb.fused_resnet_block.layouts_built - built)
    total = read_launches()
    peak = torch.cuda.max_memory_allocated()
    expected = per_unet_call(mixed, flags)
    median = statistics.median(latencies[1:])
    off = "" if flag_off is None else f" (flag-off {flag_off['latency_ms']:.3f} ms in this run)"
    print(f"{label}requests: {N_REQUESTS}; latency ms {[round(x, 3) for x in latencies]} "
          f"(the first includes loading the checkpoint); median of the rest {median:.3f} ms{off}; launches per "
          f"request {({k: v for k, v in per_request[0].items() if v})}; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB)", flush=True)
    if any(r != expected for r in per_request):
        fail(f"expected {expected} launches per {label}request, got {per_request}")
    unet = next(iter(predictor._cache.values()))[1].unet
    if unet.compute_dtype != (torch.bfloat16 if mixed else torch.float32):
        fail(f"the {label}checkpoint was served in {unet.compute_dtype}")
    events = profile(f"one {label}request", lambda: predictor.predict(imgs[0], "TEDM", 1))
    if "--use_pallas_resblock" in flags:
        print(f"{label}ResnetBlock weight layouts built per request: {layouts}", flush=True)
        if not layouts[0] or any(layouts[1:]) or any(e.key == rb.LAYOUT_RANGE for e in events):
            fail(f"{label}weight layouts were built after the first request: {layouts}")
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
    if flag_off is not None:
        off = flag_off["probs"]
        print(f"{label}vs the flag-off {'bf16 ' if mixed else ''}request from the same weights and noise (a report, "
              f"not a gate): probabilities max_abs_diff {float(np.abs(probs - off).max()):.3e}, mean "
              f"{float(np.abs(probs - off).mean()):.3e}; masks differ at "
              f"{int(((probs > 0.5) != (off > 0.5)).sum())} of {probs.size} pixels", flush=True)
    if not path_err <= tol:
        fail(f"{label}card and CPU plain path disagree: {path_err}")
    return {"launches": total, "probs": probs, "latency_ms": median}


def train_backbone(tmp, mixed: bool):
    """Phases 5 and 9: path (a) through the training entry point. fp32: with
    one validation at the last step (its 1000-step sample grid); bf16
    (``mixed``): without validation, a checkpoint at the last step. Returns
    the checkpoint, the launches and the median step time."""
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
    reset_launches()
    t0 = time.perf_counter()
    train_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated()

    recs = read_metrics(cfg.log_dir)
    steps = [r for r in recs if "train/loss" in r]
    val = [r["val/loss"] for r in recs if "val/loss" in r]
    step_ms = [1e3 * cfg.batch_size / r["train/imgs_per_sec"] for r in steps]
    # fp32 validation: one batch of val_loss (chunks of 8 timesteps, one UNet
    # call each) and the sample grid's T UNet calls, 8 linear attentions per call
    n_t = len(range(0, cfg.timesteps, max(cfg.timesteps // cfg.val_steps, 1)))
    val_fwd = 0 if mixed else 8 * (math.ceil(n_t / 8) + cfg.timesteps)
    per_step = {k: (v - (val_fwd if k == "linear_attention" else 0)) / max(len(steps), 1) for k, v in counts.items()}
    losses = [r["train/loss"] for r in steps]
    median = statistics.median(step_ms[1:])
    print(f"{label}: {len(steps)} steps at batch {cfg.batch_size}, {cfg.img_size}^2, "
          f"{wall:.1f} s wall{'' if mixed else ' with validation'}; step ms {[round(x, 1) for x in step_ms]}; "
          f"median of steps 2-{len(steps)} {median:.3f} ms = {1e3 * cfg.batch_size / median:.2f} imgs/s; "
          f"losses {losses[0]:.4f} .. {losses[-1]:.4f}; val loss {val}; "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB"
          f"{'' if mixed else ', validation included'}); launches {counts} ({val_fwd} linear_attention "
          f"in validation); per step {per_step}", flush=True)
    if len(steps) != A_STEPS or not all(math.isfinite(x) for x in losses + val) or len(val) != (0 if mixed else 1):
        fail(f"{label}: {len(steps)} steps, losses {losses}, val {val}")
    if per_step != per_unet_call(mixed, backward=True):
        fail(f"{label}: expected {per_unet_call(mixed, backward=True)} launches a step, got {per_step}")
    if mixed:
        return os.path.join(cfg.log_dir, f"step_{A_STEPS}"), counts, median
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
    return os.path.join(cfg.log_dir, "best"), counts, median


def train_opt_in(tmp, mixed: bool, flag_off_ms: float):
    """Phase 13: backbone steps at batch 16 through the training entry point
    with ``--use_pallas_resblock --use_pallas_flash``, without validation.
    Returns the launches."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.kernels import resblock as rb
    from tedm_tpu_torch.train import main as train_main

    flags = ("--use_pallas_resblock", "--use_pallas_flash")
    label = f"{label_of(mixed, flags)}path (a)"
    argv = ["--experiment", "img_only", "--synthetic_data", "--ema_decay", "0.999", "--max_steps", str(OPT_IN_STEPS),
            "--log_freq", "1", "--seed", str(SEED), "--val_freq", str(10 * OPT_IN_STEPS),
            "--log_dir", os.path.join(tmp, "train_opt_in_bf16" if mixed else "train_opt_in", "run_a"),
            *flags] + (["--mixed_precision"] if mixed else [])
    cfg = config_from_args(argv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    built = rb.fused_resnet_block.layouts_built
    t0 = time.perf_counter()
    train_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    built = rb.fused_resnet_block.layouts_built - built
    peak = torch.cuda.max_memory_allocated()
    steps = [r for r in read_metrics(cfg.log_dir) if "train/loss" in r]
    step_ms = [1e3 * cfg.batch_size / r["train/imgs_per_sec"] for r in steps]
    losses = [r["train/loss"] for r in steps]
    per_step = {k: v / max(len(steps), 1) for k, v in counts.items()}
    median = statistics.median(step_ms[1:])
    print(f"{label}: {len(steps)} steps at batch {cfg.batch_size}, {wall:.1f} s wall; step ms "
          f"{[round(x, 1) for x in step_ms]}; median of steps 2-{len(steps)} {median:.3f} ms = "
          f"{1e3 * cfg.batch_size / median:.2f} imgs/s (flag-off {flag_off_ms:.3f} ms in this run); losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}; peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); "
          f"launches per step {({k: v for k, v in per_step.items() if v})}; ResnetBlock weight layouts built "
          f"{built / max(len(steps), 1):.1f} a step (the weights move every step)", flush=True)
    if len(steps) != OPT_IN_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"{label}: {len(steps)} steps, losses {losses}")
    if per_step != per_unet_call(mixed, flags, backward=True):
        fail(f"{label}: expected {per_unet_call(mixed, flags, backward=True)} launches a step, got {per_step}")
    return counts


def step_card_vs_cpu(mixed: bool, flags=()):
    """Phases 6, 10 and 13: a training step at batch 16 under the profiler,
    then one at batch 2 on the card and on the CPU from the same weights, t
    and noise; in fp32, or in bf16 with ``mixed``; with the opt-in ``flags``."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers import diffusion as D
    from tedm_tpu_torch.trainers.common import make_optimizer, to_nchw

    cfg = config_from_args(["--experiment", "img_only", "--synthetic_data", "--seed", str(SEED),
                            "--log_dir", os.path.join(tempfile.gettempdir(), "unused"), *flags]
                           + (["--mixed_precision"] if mixed else []))
    label = label_of(mixed, flags)
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


def train_head(tmp, backbone, mixed: bool, flags=(), steps: int = B_STEPS):
    """Phases 7, 11 and 13: path (b) on a backbone of path (a), then one
    request served from its best checkpoint; in fp32, or in bf16 with
    ``mixed``; with the opt-in ``flags``. Returns the launches of its
    training run."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.serve.app import Predictor
    from tedm_tpu_torch.train import main as train_main

    label = f"{label_of(mixed, flags)}path (b)"
    logs = os.path.join(tmp, "train" + "".join("_" + t for t in ["bf16"] * mixed + [f[13:] for f in flags]), "logs")
    argv = ["--experiment", "TEDM", "--n_labelled_images", "1", "--synthetic_data",
            "--saved_diffusion_model", backbone, "--max_steps", str(steps),
            "--val_freq", str(steps), "--log_freq", "1", "--seed", str(SEED),
            "--log_dir", os.path.join(logs, "run_b"), *flags] + (["--mixed_precision"] if mixed else [])
    cfg = config_from_args(argv)
    reset_launches()
    t0 = time.perf_counter()
    train_main(argv, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()

    recs = read_metrics(cfg.log_dir)
    done = [r for r in recs if "train/loss" in r]
    val = [r for r in recs if "val/dice" in r]
    step_ms = [1e3 * r["train/imgs_per_sec"] ** -1 for r in done]
    print(f"{label}: {len(done)} steps of 1 image x 8 timesteps, {wall:.1f} s wall with "
          f"validation; median step {statistics.median(step_ms[1:]):.3f} ms; losses "
          f"{done[0]['train/loss']:.4f} .. {done[-1]['train/loss']:.4f}; val {val}; "
          f"launches {({k: v for k, v in counts.items() if v})}", flush=True)
    # one UNet call of 8 timesteps per step and per val batch (25 images, 2 batches)
    expected = {k: v * (steps + 2) for k, v in per_unet_call(mixed, flags).items()}
    if len(done) != steps or len(val) != 1 or counts != expected:
        fail(f"{label}: {len(done)} steps, val {val}, launches {counts}, expected {expected}")
    if not all(math.isfinite(v) for v in val[0].values()):
        fail(f"{label}: val metrics {val[0]}")

    mask = Predictor(logs_root=logs, device="cuda").predict(
        np.random.RandomState(SEED).rand(1, cfg.img_size, cfg.img_size, 1).astype(np.float32), "TEDM", 1)
    if mask.shape != (cfg.img_size, cfg.img_size) or not set(np.unique(mask)) <= {0.0, 1.0}:
        fail(f"{label}: served mask of shape {mask.shape}")
    print(f"{label}: served one request from {cfg.log_dir}/best, mask foreground {mask.mean():.4f}")
    return counts


def add_paths(*runs) -> dict:
    """Each kernel's launches summed over the named runs of its main path:
    {kernel: {path: launches}}, paths with no launch left out."""
    out = {k: {} for k in KERNELS}
    for path, counts in runs:
        for k, v in counts.items():
            if v:
                out[k][path] = v
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the port on a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tedm_tpu_torch.kernels import _build
    from tedm_tpu_torch.kernels import attn_block as ab
    from tedm_tpu_torch.kernels import flash_attention as fa
    from tedm_tpu_torch.kernels import groupnorm as gn
    from tedm_tpu_torch.kernels import linear_attention as la
    from tedm_tpu_torch.kernels import resblock as rb

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
        gn_rows = check_groupnorm(gn, gen)
        rb_rows, rb_launches, rb_residual = check_resblock(rb, gen)
        rbb_rows, rbb_launches = check_resblock_backward(rb, gen)
        fa_rows, fa_launches = check_flash(fa, gen)

    with tempfile.TemporaryDirectory() as tmp:
        with Phase("4. serving path"):
            served = serve(tmp, mixed=False)
        with Phase("5. training path (a): backbone"):
            backbone, a32, a32_ms = train_backbone(tmp, mixed=False)
        with Phase("6. training step: profile, card vs CPU"):
            step_card_vs_cpu(mixed=False)
        with Phase("7. training path (b): TEDM head"):
            b32 = train_head(tmp, backbone, mixed=False)
        with Phase("8. bf16 serving path"):
            served16 = serve(tmp, mixed=True)
        with Phase("9. bf16 training path (a): backbone"):
            backbone16, a16, a16_ms = train_backbone(tmp, mixed=True)
        with Phase("10. bf16 training step: profile, card vs CPU"):
            step_card_vs_cpu(mixed=True)
        with Phase("11. bf16 training path (b): TEDM head"):
            b16 = train_head(tmp, backbone16, mixed=True)
        opt_in = []
        with Phase("12. opt-in serving"):
            for flags in (("--use_pallas_groupnorm", "--use_pallas_flash"), ("--use_pallas_resblock", "--use_pallas_flash")):
                for mixed, off in ((False, served), (True, served16)):
                    run = serve(tmp, mixed, flags, flag_off=off)
                    opt_in.append((f"{label_of(mixed, flags)}serving", run["launches"]))
        with Phase("13. opt-in training"):
            flags = ("--use_pallas_resblock", "--use_pallas_flash")
            for mixed, off_ms in ((False, a32_ms), (True, a16_ms)):
                opt_in.append((f"{label_of(mixed, flags)}training (a)", train_opt_in(tmp, mixed, off_ms)))
                step_card_vs_cpu(mixed, flags)
            opt_in.append(("--use_pallas_groupnorm training (b)",
                           train_head(tmp, backbone, False, ("--use_pallas_groupnorm",), HEAD_STEPS)))

    paths = add_paths(("serving", served["launches"]), ("training (a)", a32), ("training (b)", b32),
                      ("bf16 serving", served16["launches"]), ("bf16 training (a)", a16),
                      ("bf16 training (b)", b16), *opt_in)
    bounded = lambda rows: "bytes" if all(r["bound_by"] == "bytes" for r in rows) else "operations"
    gn_req = [(s, torch.float32, f) for s, f in gn_calls(8)]
    rb_req = [(s, torch.float32) for s in rb_shapes(8)]

    def entry(name, source, replaces, rows, request, step, **extra):
        """A kernel's line: times and bound of one serving request's calls in
        fp32 (batch 8), and in bf16 and of a training step (batch 16) beside;
        ``library_ms`` where the rows time a library call, else None."""
        as16 = lambda keys: [tuple(torch.bfloat16 if e is torch.float32 else e for e in k) for k in keys]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(paths[name].values()), "launches_by_path": paths[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows.values() if r["dtype"] == "fp32"),
            "max_abs_err_bf16": max(r["max_abs_err"] for r in rows.values() if r["dtype"] == "bf16"),
            "min_control_err": min(r["min_control_err"] for r in rows.values()),
            "library_ms": None, **calls_sum(rows, request), "bound_by": bounded([rows[k] for k in request]),
            "bf16": calls_sum(rows, as16(request)), "train_step": calls_sum(rows, step),
            "train_step_bf16": calls_sum(rows, as16(step)),
            **extra,
        }

    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "source": "tedm_tpu_torch/kernels/csrc/linear_attention.cu",
        "replaces": "tedm_tpu/ops/pallas/linear_attention.py:122",
        "launches": sum(paths["linear_attention"].values()),
        "launches_by_path": paths["linear_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in fwd_rows.values()),
        # times and bound of one serving request's 8 calls
        **calls_sum(fwd_rows, 2 * SERVE_SHAPES),  # each shape down and up
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in fwd_rows.values()) else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
        "train_step": calls_sum(fwd_rows, 2 * TRAIN_SHAPES),
        # CUDA launches of one request's and one step's 8 calls, as phase 3 profiled them
        "cuda_launches": {"request": sum(fwd_rows[sh]["cuda_launches"] for sh in 2 * SERVE_SHAPES),
                          "train_step": sum(fwd_rows[sh]["cuda_launches"] for sh in 2 * TRAIN_SHAPES)},
        "per_shape": list(fwd_rows.values()),
        "per_launch": {str(k): r["per_launch"] for k, r in fwd_rows.items()},
    }, {
        "name": "linear_attention_backward",
        "route": "cuda",
        "source": "tedm_tpu_torch/kernels/csrc/linear_attention.cu",
        "replaces": "tedm_tpu/ops/pallas/linear_attention.py:141",
        "launches": sum(paths["linear_attention_backward"].values()),
        "launches_by_path": paths["linear_attention_backward"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows.values()),
        "max_rel_err": max(r["max_rel_err"] for r in bwd_rows.values()),
        # times and bound of one training step's 8 calls
        **calls_sum(bwd_rows, 2 * TRAIN_SHAPES),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bwd_rows.values()) else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
        "per_shape": list(bwd_rows.values()),
        "per_launch": {str(k): r["per_launch"] for k, r in bwd_rows.items() if "per_launch" in r},
    }, {
        "name": "prenorm_linear_attention",
        "route": "cuda",
        "source": "tedm_tpu_torch/kernels/csrc/attn_block.cu",
        "replaces": "tedm_tpu/ops/pallas/attn_block.py:136",
        "launches": sum(paths["prenorm_linear_attention"].values()),
        "launches_by_path": paths["prenorm_linear_attention"],
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
    },
        # no single PyTorch call computes GroupNorm with FiLM, or the block
        entry(GN, "tedm_tpu_torch/kernels/csrc/groupnorm.cu", "tedm_tpu/ops/pallas/groupnorm.py:133", gn_rows,
              gn_req, [(s, torch.float32, f) for s, f in gn_calls(16)],
              per_launch={f"{k[0]} {dtype_name(k[1])}": {"cluster": r["per_launch"], "two_pass": r["two_pass_per_launch"]}
                          for k, r in gn_rows.items() if "per_launch" in r}),
        entry(RB, "tedm_tpu_torch/kernels/csrc/resblock.cu", "tedm_tpu/ops/pallas/resblock.py:199", rb_rows,
              rb_req, [(s, torch.float32) for s in rb_shapes(16)], per_launch=rb_launches,
              residual_routes=rb_residual),
        {
            "name": RBB, "route": "cuda", "source": "tedm_tpu_torch/kernels/csrc/resblock_backward.cu",
            "replaces": "tedm_tpu/ops/pallas/resblock.py:303",
            "launches": sum(paths[RBB].values()), "launches_by_path": paths[RBB],
            "max_abs_err": max(r["max_abs_err"] for r in rbb_rows.values() if r["dtype"] == "fp32"),
            "max_abs_err_bf16": max(r["max_abs_err"] for r in rbb_rows.values() if r["dtype"] == "bf16"),
            "max_rel_err": max(r["max_rel_err"] for r in rbb_rows.values() if r["dtype"] == "fp32"),
            "max_rel_err_bf16": max(r["max_rel_err"] for r in rbb_rows.values() if r["dtype"] == "bf16"),
            "min_control_err": min(r["min_control_err"] for r in rbb_rows.values()),
            # times and bound of one training step's 19 backward calls (batch 16) in
            # fp32, bf16 beside; library_ms: the flag-off block's cuDNN backward;
            # recompute_ms: the earlier backward, the plain block recomputed under autograd
            **calls_sum(rbb_rows, [(s, torch.float32) for s in rb_shapes(16)]),
            "bound_by": bounded([rbb_rows[(s, torch.float32)] for s in rb_shapes(16)]),
            "bf16": calls_sum(rbb_rows, [(s, torch.bfloat16) for s in rb_shapes(16)]),
            "per_shape": list(rbb_rows.values()), "per_launch": rbb_launches,
        },
        # the mid attention, one call; library_ms: F.scaled_dot_product_attention
        # (scale=16) on pre-normalised q and k
        entry(FA, "tedm_tpu_torch/kernels/csrc/flash_attention.cu", "tedm_tpu/ops/pallas/flash_attention.py:114",
              fa_rows, [(8, 256, torch.float32)], [(16, 256, torch.float32)], per_shape=list(fa_rows.values()),
              per_launch=fa_launches),
    ]
    for kern in kernels:
        if kern["launches"] == 0:
            fail(f"{kern['name']} was never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
