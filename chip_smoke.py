#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tedm_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. environment: the card's name and power limit (nvidia-smi); TF32 off,
     and bf16 products summed in fp32 (no reduced-precision split-K);
  2. build: every CUDA source in tedm_tpu_torch/kernels/csrc, one nvcc per
     source, all started together (and no library of an earlier run kept,
     phase 21's host library either: the port builds it at first use);
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
     and 16, in fp32 and bf16 (and the linear attention, GroupNorm,
     ResnetBlock and its backward and flash kernels at the batch-32 fp32
     shapes of a contrastive step, two views of 16, without FiLM), and at
     edges, each with its controls (the
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
 14. the eval harness on a corpus of files: the hard synthetic corpus
     written at 128x128 by scripts/port/export_corpus.py (JSRT 197/25/25,
     NIH 25, Montgomery 25, CXR14 64); from its JSRT files, through
     train.main on phase 5's backbone, a TEDM head, a PDDM probe at
     timestep 1 and the supervised baseline at n = 1 (fp32), and the
     baseline at n = 197 (batch 16) in fp32 and bf16, each with and without
     ``--use_pallas_resblock --use_pallas_flash``, and in fp32 with
     ``--use_pallas_groupnorm`` (each also one batch-2 step on the card and
     on the CPU plain path from the same weights, at phase 6's and 10's
     gates); testing_shared_weights on the TEDM head and run_tests on the
     baseline and PDDM heads over JSRT_val, JSRT_test, NIH and Montgomery
     (seconds, images/s, launches); each npz read back and its Dice
     recomputed on the CPU; the probabilities of each head on the first
     JSRT_val batch (16 images), with noise given, against the plain path
     on the card (the config under ``--no_pallas``: no kernel launch), and
     on its first images whose rows fill 16 (TEDM's 8 timesteps: 2 images;
     the baseline and PDDM: all 16) against the CPU plain path; then the
     port's ``reporting.tables`` over the npz files,
     its main-table rows (Dice x100 at n = 1) printed, each with a number;
 15. the contrastive arms through train.main: global_cl on synthetic CXR14
     (batch 16, 32 views, fp32; 4 linear-attention forward and 4 backward
     launches a step) and local_cl warm-started from it (6 forward, 2
     backward: only ups[:2] trains), each with a validation of 2 batches and
     a batch-2 step on the card and on the CPU plain path from the same
     weights and views; on the corpus's JSRT files (n = 197, batch 16,
     frozen encoder until step 3, augmented) glob_loc_finetune in fp32 and
     bf16 and global_finetune in fp32, bf16 and fp32 with resblock + flash, each
     with a frozen batch-2 step against the CPU; run_tests on the
     glob_loc_finetune run over the four sets; one Predictor("Global & Local
     CL") request against the CPU plain path;
 16. a conditional backbone through train.main on the corpus's JSRT files
     (batch 16, one validation with its sample grid), run_tests on it with
     --ddim_steps 4 over the four sets (5 trajectories a batch, 8
     linear-attention launches a UNet call), and one DDIM and one
     DPM-Solver++(2M) trajectory of one image (4 steps) on the card against
     the CPU plain path from the same x_T;
 17. the rest of serving and the training tooling: phase 4's weights served
     under ``--no_pallas`` in fp32 and bf16 (no B.1 or B.2 launch, within
     the path gates of the default path); Predictor's CUDA graphs for fp32
     and bf16, default and resblock + flash, against eager requests (host
     latency, busy share under torch.profiler, a replay's kernel calls
     counted from its trace, probabilities equal), and peak memory with 4
     graphed models in one Predictor; phase 4's TEDM checkpoint exported
     (``serve/export.py``) in fp32 and bf16, and phase 12's bf16 resblock +
     flash one, each called twice in a fresh process (equal to Predictor's
     folded rows, one UNet call's launches, no weight laid out by the second
     call); exported samplers (2-step DDIM and the ancestral step on phase 5's
     backbone, the ancestral step on phase 9's bf16 one, DPM++ on phase
     16's, 2 steps) against the eager loops, with the same counts of launches and
     layouts (every export made by one of three processes started at the
     phase's start, beside the rest of it); ``--remat`` path (a) runs and one
     step against the step without it, in fp32 and with resblock + flash;
     a ``--profile_dir`` run whose trace holds B.1 and B.1b; the grid
     (``predict``) over phases 14-15's checkpoints, cold and warm;
 18. data parallel (``parallel/mesh.py``) in a world of one under NCCL, the
     card's one rank launched as torchrun would (the env set here, a free
     port): the backbone at batch 16 through train.main --multihost under
     DDP and under --param_sharding fsdp, 5 steps each, in fp32 (B.1,
     B.1b), bf16 with resblock + flash (B.2, B.4, B.4b, B.5) and with
     groupnorm (B.3), with cuDNN's deterministic algorithms, each against
     the same run without a process group: the losses, and the parameters
     after step 4, at phases 6 and 10's gates, the launches a step equal,
     the step times side by side; under FSDP at a large lr, every fused
     ResnetBlock's and PreNorm block's output in every training forward
     against its plain version on the weights of that step (a layout cached
     from an earlier step's weights would miss), and the same run without
     layout epochs as a control, with how often a weight came back as the
     same tensor, address and version (the case the epochs guard;
     reported); DDP of 2 ranks on the one card over gloo (2 backbone steps
     at batch 8 a rank; NCCL refuses two ranks on one device), both ranks
     logging the same loss; run_tests --multihost over phase 14's baseline
     against its npz files. The 2 ranks of phases 18-20 are two processes
     started before phase 14 (``RankPair``); each of these phases hands
     them its job at its start and runs its world of one and its
     one-process steps beside it, so their step times are not clean;
 19. the model mesh axis (``parallel/tensor_parallel.py``): (a) phase 18's
     backbone runs under ``--mesh_shape 1 1 --mesh_axes data model
     --param_sharding tp`` in a world of one under NCCL (the TP code and its
     collectives on NCCL), on each of its paths, against the run without a
     group at phase 18's gates, the launches a step equal; (b) TP of 2
     ranks on the one card over gloo, mesh (1, 2) at ``--tp_min_width
     256``: a backbone step (batch 4) in fp32 (B.1, B.1b) and in bf16 with
     resblock + flash (B.2, B.4, B.4b, B.5, their weights gathered) and a
     TEDM head step with groupnorm (B.3; its frozen backbone sharded too),
     each against one process on the same batch at phases 6 and 10's gates,
     both ranks' replicated parameters equal, a rank's parameter bytes the
     rule's count; (c) ``--data_backend device``: backbone steps whose
     batches are rendered on the card, and one index rendering the same
     pixels in batches of other composition; (d) ``--data_backend grain``:
     trains where grain imports, else refuses, naming the package;
 20. the spatial mesh axis (``parallel/spatial.py``): (a) path (a) at batch
     16 under ``--mesh_shape 1 1 --mesh_axes data spatial --shard_spatial``
     in a world of one under NCCL, in fp32, bf16 and fp32 with groupnorm +
     resblock + flash, SP_STEPS steps each, against the run without a
     group: losses and parameters bit for bit, launches a step equal; (b)
     SP of 2 ranks on the one card over gloo, mesh (1, 2), each rank holding
     64 of the 128 rows: a backbone step (batch 4) in fp32 (B.1, B.1b) and
     in bf16 with resblock + flash (B.2, B.4, B.4b, B.5, on gathered maps)
     and a TEDM head step with groupnorm (B.3, B.1), each against one
     process on the same batch at phases 6 and 10's gates, both ranks'
     parameters equal, each rank's launches one process's, and each rank's
     peak memory beside one process's (a record); (c) the contrastive arms
     under ``--shard_spatial``: a global_cl and a local_cl step at full
     width (128^2, 2 images, the views built whole from a seeded generator
     on the card, then each rank's rows) on a (1, 1) mesh in a world of one
     against no group bit for bit, and on (b)'s 2 ranks against one
     process at (b)'s gates, with a glob_loc_finetune step in bf16
     (encoder frozen), both ranks' parameters equal, peak memory a rank
     beside one process's; (d) run_tests of a seeded TEDM head checkpoint
     whose config shards spatially, on (b)'s 2 ranks (2 images a set),
     against the same CLI in one process: the npz files' probabilities at
     PATH_TOL, each image's Dice, precision and recall to 1e-6;
 21. the host image path (``tedm_tpu_torch/native``): (a) g++'s seconds to
     build the library into a fresh directory and its flavor (``png``, or
     ``resize`` where libpng's headers are missing or the PNG build fails,
     said on a line of its own with g++'s output); the phase fails if the
     port's library is not available; (b) this
     machine's Pillow version, and the library against it byte for byte:
     three filters at (2048^2, 1024^2, 256^2, 100x173 -> 128^2) and 131x67 ->
     37x91, and with libpng the PNG route, one file and a batch, on gray8,
     gray16, gray16 + alpha, RGB, RGBA, palette and 1-bit files; (c) a CXR14
     corpus of 64 PNGs at 1024^2 and a JSRT one of 16 PNGs at 2048^2 with
     their two GIF lungs at SCR's 1024^2 (export_corpus.py's writer), each
     read by the port's train loader (batch 16 at 128^2, the default 4
     threads; CXR14 through its whole-batch ``get_batch``) with
     ``TEDM_NATIVE=0`` and without, 3 runs a route in turns: ms a batch
     after the first beside the step each corpus feeds and as a share of
     it (CXR14 path (a)'s, phase 5; JSRT the fp32 baseline's at batch 16,
     phase 14), the routes' batches byte-equal;
then one JSON line listing every kernel (and phases 14-21's reports) and the
final JSON status line.
"""

from __future__ import annotations

import collections
import contextlib
import io
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
CL_SHAPES = [(32, 4, 32, n) for n in (256, 1024, 4096, 16384)]     # a CL step: two views of 16
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
EVAL_STEPS = 4                 # training steps of each phase-14 run
EVAL_SETS = {"JSRT_val": 25, "JSRT_test": 25, "NIH": 25, "Montgomery": 25}  # images of each eval set
# UNet rows of phase 14's card-vs-CPU check: the first images of the first
# JSRT_val batch whose rows (images x the head's timesteps) fill 16; the
# whole batch is held against the plain path on the card
EVAL_CPU_ROWS = 16
CL_STEPS = 4                   # steps of each phase-15 pretraining run (batch 16, 32 views)
CL_VAL_BATCHES = 2             # --max_val_steps of the pretraining runs
COND_STEPS = 4                 # conditional backbone steps of phase 16
DDIM_STEPS = 4                 # --ddim_steps of phase 16's eval and its trajectories
EVAL_RUNS = 5                  # trajectories a batch in the conditional eval (run_tests.py:121-137)
# one DDIM_STEPS-step trajectory on the card against the CPU plain path,
# absolute on the sample in [-1, 1]: measured on an H100 at 10 steps 7.2e-7
# (DDIM) and 1.4e-6 (DPM++(2M)); the gate is 70x the larger
SAMPLER_TOL = 1e-4
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
    profile.last = {"launches": sum(e.count for e in kernels), "busy_ms": busy_ms, "wall_ms": wall_ms}
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
    for shape in SERVE_SHAPES + TRAIN_SHAPES + CL_SHAPES:
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
              torch.randn(s, generator=gen, device="cuda") * s[-1]) for s in TRAIN_SHAPES + CL_SHAPES]
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
            # a CL step (batch 32, fp32) runs without FiLM: no time embedding
            cl = [(s, False) for s, _ in gn_calls(32)] if dtype == torch.float32 else []
            for shape, film in dict.fromkeys(gn_calls(8) + gn_calls(16) + cl):
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
            for shape in dict.fromkeys(rb_shapes(32)) if dtype == torch.float32 else ():
                # a CL step: batch 32, fp32, no FiLM; held and timed, the kernel alone
                args = rb_inputs(gen, shape, dtype, film=False)
                err, control = rb_check(rb, args, (shape, dtype, "no FiLM"))
                b, cin, cout, h, w = shape
                rows[(shape, dtype)] = row = {
                    "shape": list(shape), "dtype": dtype_name(dtype), "film": False, "max_abs_err": err,
                    "min_control_err": control, "ms": device_ms(lambda: rb.fused_resnet_block(*args)),
                    **bound(*resblock_call(b, cin, cout, h * w, args[0].element_size()))}
                print(f"fused_resnet_block {shape} fp32 no FiLM: max_abs_err {err:.3e} (controls >= {control:.3f}) "
                      f"kernel {row['ms']:.4f} ms bound {1e3 * row['bound_ms']:.2f} us ({row['bound_by']})", flush=True)
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
            if dtype == torch.float32:  # a CL step: batch 32, no FiLM
                cases += [(s, False) for s in dict.fromkeys(rb_shapes(32))]
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
            for b, n in [(8, 256), (16, 256), (32, 256), (8, 1024), (8, 4096), (2, 1), (3, 17), (1, 255)]:
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
    ResnetBlock wins over GroupNorm; ``--no_pallas`` takes the first two off."""
    counts = {"prenorm_linear_attention": 8} if mixed else {"linear_attention": 8}
    if backward and not mixed:
        counts["linear_attention_backward"] = 8
    if "--no_pallas" in flags:
        counts = {}
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


def flag_fields(flags=()) -> dict:
    """The config fields of the kernel flags."""
    return {"use_pallas": False} if "--no_pallas" in flags else {f[2:]: True for f in flags}


def serve_logs(tmp, mixed: bool = False, flags=()) -> str:
    """The logs root of a serving phase's checkpoint (phases 4, 8, 12, 17)."""
    name = "_".join(["serve"] + ["bf16"] * mixed + [f.lstrip("-").replace("use_pallas_", "") for f in flags])
    return os.path.join(tmp, name, "logs")


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


def eager_predictor(logs):
    """A ``Predictor`` on the card whose every request runs eagerly, as the
    CPU serves (``serve.app.eager_sigmoids``): eager latencies, and host
    launch counters, which a graph replay does not move."""
    from tedm_tpu_torch.serve import app

    predictor = app.Predictor(logs_root=logs, device="cuda")
    predictor._sigmoids = lambda ckpt_dir, task, x, noise: app.eager_sigmoids(task, x, noise)
    return predictor


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
    logs = serve_logs(tmp, mixed, flags)
    if mixed or flags:
        state, cfg = load_checkpoint(os.path.join(serve_logs(tmp), "TEDM", "1", "best"), verbose=False)
        cfg = cfg.replace(mixed_precision=mixed, **flag_fields(flags))
    else:
        state, cfg = random_tedm(tmp)
    save_checkpoint(os.path.join(logs, "TEDM", "1", "best"), state, cfg)
    del state
    rs = np.random.RandomState(SEED)
    imgs = [rs.rand(1, cfg.img_size, cfg.img_size, 1).astype(np.float32) for _ in range(N_REQUESTS)]
    predictor = eager_predictor(logs)  # phase 17 measures the graphs
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

    mask = eager_predictor(logs).predict(
        np.random.RandomState(SEED).rand(1, cfg.img_size, cfg.img_size, 1).astype(np.float32), "TEDM", 1)
    if mask.shape != (cfg.img_size, cfg.img_size) or not set(np.unique(mask)) <= {0.0, 1.0}:
        fail(f"{label}: served mask of shape {mask.shape}")
    print(f"{label}: served one request from {cfg.log_dir}/best, mask foreground {mask.mean():.4f}")
    return counts


# ------------------------------------------------------------------ phase 14

def export_hard_corpus(tmp) -> str:
    """The hard corpus at the default 128x128 as files, by the port's own
    writer (scripts/port/export_corpus.py)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "port"))
    import export_corpus

    root = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    export_corpus.main(["--root", root, "--img_size", "128", "--hard", "--n_cxr", "64", "--n_crossdomain",
                        str(EVAL_SETS["NIH"]), "--seed", str(SEED)])
    print(f"corpus written in {time.perf_counter() - t0:.1f} s", flush=True)
    return root


def corpus_run(tmp, root, name, argv, mixed=False, flags=(), backward=False):
    """One head or baseline training run of ``EVAL_STEPS`` steps on the
    corpus's JSRT files through train.main, with its validation at the last
    step. Checks the steps, the validation and the launches (one UNet call a
    step, forward and, with ``backward``, backward; one a val batch).
    Returns the experiment directory, the launches and the median step ms."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.train import main as train_main

    argv = argv + list(flags) + (["--mixed_precision"] if mixed else []) + [
        "--data_dir", os.path.join(root, "JSRT"), "--splits_dir", os.path.join(root, "data"), "--seed", str(SEED),
        "--max_steps", str(EVAL_STEPS), "--val_freq", str(EVAL_STEPS), "--log_freq", "1",
        "--log_dir", os.path.join(tmp, "eval_logs", name.replace(" ", "_"))]
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
    batch = min(cfg.batch_size, cfg.n_labelled_images)
    step_ms = [1e3 * batch / r["train/imgs_per_sec"] for r in done]
    median = statistics.median(step_ms[1:])
    val_batches = math.ceil(EVAL_SETS["JSRT_val"] / cfg.batch_size)
    per_step, per_val = per_unet_call(mixed, flags, backward=backward), per_unet_call(mixed, flags)
    expected = {k: per_step[k] * EVAL_STEPS + per_val[k] * val_batches for k in KERNELS}
    print(f"{name}: {len(done)} steps at batch {batch}, {wall:.1f} s wall with validation; step ms "
          f"{[round(x, 1) for x in step_ms]}; median of steps 2-{len(done)} {median:.3f} ms = "
          f"{1e3 * batch / median:.2f} imgs/s; losses {done[0]['train/loss']:.4f} .. {done[-1]['train/loss']:.4f}; "
          f"val dice {[round(r['val/dice'], 4) for r in val]}; launches {({k: v for k, v in counts.items() if v})}",
          flush=True)
    # precision is 0/0, NaN, on an image where the head predicts no lung, as
    # a baseline does after a few steps (the reference's metric)
    if len(done) != EVAL_STEPS or len(val) != 1 or not all(math.isfinite(val[0][k]) for k in ("val/loss", "val/dice")):
        fail(f"{name}: {len(done)} steps, val {val}")
    if counts != expected:
        fail(f"{name}: launches {counts}, expected {expected}")
    return cfg.log_dir, counts, median


def baseline_step_card_vs_cpu(root, mixed: bool, flags=(), argv=()):
    """One baseline training step at batch 2 (the corpus's first two JSRT
    train images) on the card and on the CPU plain path, from the same
    weights (initialised from the seed): the loss and every gradient. With
    ``argv`` naming a contrastive finetune and its CL checkpoint, the UNet is
    warm-started from it and the step is a frozen one: the frozen
    parameters' gradients are 0 and their values stay."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.data.datasets import JSRTDataset
    from tedm_tpu_torch.trainers import baseline, contrastive
    from tedm_tpu_torch.trainers.common import make_optimizer, make_train_step, to_nchw

    cfg = config_from_args(["--experiment", "baseline", "--seed", str(SEED), "--log_dir",
                            os.path.join(tempfile.gettempdir(), "unused"), *flags, *argv]
                           + (["--mixed_precision"] if mixed else []))
    finetune = cfg.experiment != "baseline"
    data = JSRTDataset(os.path.join(root, "JSRT"), "JSRT_train_split.csv", cfg.img_size,
                       splits_dir=os.path.join(root, "data"))
    x, y = (np.stack(a) for a in zip(data[0], data[1]))
    results = {}
    for device in ("cuda", "cpu"):
        task = (contrastive.build_task if finetune else baseline.build_task)(cfg, device)
        frozen = contrastive.frozen_parameters(task) if finetune else []
        kept = [p.detach().clone() for p in frozen]
        step = make_train_step(task, make_optimizer(cfg, task.trained.parameters()), frozen)
        loss, _ = step(to_nchw(x, device), to_nchw(y, device), torch.ones(2, device=device), freeze=finetune)
        if not all(torch.equal(p, k) for p, k in zip(frozen, kept)):
            fail(f"{cfg.experiment}: a frozen parameter moved on the {device}")
        results[device] = (loss.item(), {n: p.grad.cpu() for n, p in task.unet.named_parameters() if p.grad is not None})
    (loss_g, grads_g), (loss_c, grads_c) = results["cuda"], results["cpu"]
    label = f"{label_of(mixed, flags)}{cfg.experiment}"
    if sorted(grads_g) != sorted(grads_c) or any("time_mlp" in n for n in grads_c):
        fail(f"{label}: gradients of other parameters on the card and on the CPU")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    grad_errs = {n: rel_err(grads_g[n], grads_c[n]) for n in grads_c}
    worst = max(grad_errs, key=grad_errs.get)
    loss_tol, grad_tol = (BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL) if mixed else (STEP_LOSS_TOL, STEP_GRAD_TOL)
    print(f"{label} step at batch 2{' (frozen: the encoder and mid get 0)' if finetune else ''}, card vs CPU "
          f"plain path: loss {loss_g:.6f} vs {loss_c:.6f} (relative {loss_err:.2e}, tol {loss_tol}); gradients of "
          f"{len(grad_errs)} tensors (no time MLP), worst relative to the tensor's largest entry "
          f"{grad_errs[worst]:.2e} at {worst} (tol {grad_tol}), median {statistics.median(grad_errs.values()):.2e}",
          flush=True)
    if not (math.isfinite(loss_g) and loss_err <= loss_tol and grad_errs[worst] <= grad_tol):
        fail(f"the {label} step on the card disagrees with the CPU plain path")
    return {"loss_rel_err": loss_err, "worst_grad_rel_err": grad_errs[worst]}


class Marks(io.TextIOBase):
    """Passes an eval CLI's output on and stamps the time of each "Testing
    <set> set" line, where the CLI starts a set."""

    def __init__(self):
        self.marks = []

    def write(self, text):
        if text.startswith("Testing "):
            self.marks.append((text.split()[1], time.perf_counter()))
        return sys.__stdout__.write(text)


def per_set_times(marks, end) -> dict:
    """Seconds and images/s of each set, from one "Testing" stamp to the next."""
    stamps = [t for _, t in marks.marks] + [end]
    return {key: {"seconds": b - a, "images_per_s": EVAL_SETS[key] / (b - a)}
            for (key, a), b in zip(marks.marks, stamps[1:])}


def check_npz(name, exp_dir) -> dict:
    """Each set's npz read back: y_hat of the set's size in [0, 1], its Dice
    recomputed on the CPU. Returns the mean Dice of each set."""
    from tedm_tpu_torch.eval import harness as H

    dice = {}
    for key, n in EVAL_SETS.items():
        out = H.load_output(os.path.join(exp_dir, f"{key}_predictions.npz"))
        if out["y_hat"].shape != (n, 128, 128, 1) or not (np.isfinite(out["y_hat"]).all()
                                                         and 0 <= out["y_hat"].min() and out["y_hat"].max() <= 1):
            fail(f"{name} {key}: y_hat of shape {out['y_hat'].shape}")
        again = H.compute_output(out["y_hat"], out["y_star"])["dice"]
        if not np.array_equal(again, out["dice"], equal_nan=True):
            fail(f"{name} {key}: the npz's Dice is not that of its y_hat")
        dice[key] = float(np.nanmean(out["dice"]))
    return dice


def plain_task_on_card(exp_dir):
    """An experiment's eval task on the card with the kernels off (its
    config under ``--no_pallas``): the plain path at the path's shapes."""
    from tedm_tpu_torch.eval import harness as H

    ckpt = os.path.join(exp_dir, "best")
    config = H.load_config(ckpt).replace(use_pallas=False)
    task = H.build_eval_task(config, "cuda")
    state, _ = H.load_checkpoint(ckpt, config, map_location="cuda")
    for key, module in task.modules.items():
        module.load_state_dict(state[key])
    return task


def evaluate(name, cli, exp_dir, root):
    """One eval CLI over the four sets of the corpus: seconds, images/s and
    launches (one UNet call a batch); each npz read back, its Dice
    recomputed on the CPU; and the first JSRT_val batch's probabilities,
    with noise given, on the card against the plain path on the card (the
    whole batch: the path's call shapes) and against the CPU plain path
    (the images whose rows fill EVAL_CPU_ROWS)."""
    from tedm_tpu_torch.eval import harness as H

    reset_launches()
    marks = Marks()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(marks):
        cli.main(["--experiment", exp_dir, "--nih_path", os.path.join(root, "NIH"),
                  "--mon_path", os.path.join(root, "Montgomery")], device="cuda")
    torch.cuda.synchronize()
    end = time.perf_counter()
    secs = end - t0
    counts = read_launches()
    batches = sum(math.ceil(n / 16) for n in EVAL_SETS.values())
    expected = {k: v * batches for k, v in per_unet_call(False).items()}
    images = sum(EVAL_SETS.values())
    per_set = per_set_times(marks, end)
    by_set = ", ".join(f"{k} {v['seconds']:.3f} s = {v['images_per_s']:.1f} imgs/s" for k, v in per_set.items())
    print(f"{name} eval: {images} images of 4 sets in {secs:.2f} s = {images / secs:.1f} imgs/s, of which the "
          f"checkpoint load and loaders {marks.marks[0][1] - t0:.2f} s; by set (prediction, metrics, npz): {by_set}; "
          f"launches {({k: v for k, v in counts.items() if v})}", flush=True)
    if sorted(per_set) != sorted(EVAL_SETS):
        fail(f"{name} eval: sets {sorted(per_set)}")
    if counts != expected:
        fail(f"{name} eval: launches {counts}, expected {expected}")
    dice = check_npz(name, exp_dir)

    config, task = H.load_experiment(exp_dir, "cuda")
    _, task_cpu = H.load_experiment(exp_dir, "cpu")
    batch = next(iter(H.build_jsrt_loaders(config)["val"]))
    b, steps = len(batch["valid"]), len(task.t_steps)
    noise = np.random.RandomState(SEED).randn(steps * b, 128, 128, 1).astype(np.float32) if steps else None
    whole = None if noise is None else [noise]
    on_card, _ = H.predict_dataset(task, [batch], fold=task.fold, noise=whole)
    reset_launches()
    on_plain, _ = H.predict_dataset(plain_task_on_card(exp_dir), [batch], fold=task.fold, noise=whole)
    plain_launches = {k: v for k, v in read_launches().items() if v}
    plain_err = float(np.abs(on_card - on_plain).max())
    # the CPU takes the first n images, and their rows of the step-major noise
    n = min(b, max(1, EVAL_CPU_ROWS // max(steps, 1)))
    head, head_noise = {k: v[:n] for k, v in batch.items()}, None
    if noise is not None:
        head_noise = [noise.reshape(steps, b, *noise.shape[1:])[:, :n].reshape(-1, *noise.shape[1:])]
    t0 = time.perf_counter()
    on_cpu, _ = H.predict_dataset(task_cpu, [head], fold=task.fold, noise=head_noise)
    cpu_s = time.perf_counter() - t0
    err = float(np.abs((on_card[:, :n] if task.fold > 1 else on_card[:n]) - on_cpu).max())
    print(f"{name}: mean Dice {dice}; first JSRT_val batch ({b} images, {max(steps, 1) * b} UNet rows) on the card "
          f"against the plain path on the card (kernels off, launches {plain_launches}): max_abs_err "
          f"{plain_err:.3e}; its first {n} images ({max(steps, 1) * n} rows) against the CPU plain path: max_abs_err "
          f"{err:.3e} (tol {PATH_TOL} each); CPU {cpu_s:.1f} s", flush=True)
    if plain_launches or not (plain_err <= PATH_TOL and err <= PATH_TOL):
        fail(f"{name}: the card disagrees with the plain path on the first JSRT_val batch: {plain_err} on the "
             f"card (launches {plain_launches}), {err} on the CPU")
    return counts, {"seconds": secs, "images": images, "images_per_s": images / secs, "per_set": per_set,
                    "dice": dice, "first_batch_max_abs_err": {"plain_on_card": plain_err, "cpu": err}}


def eval_harness(tmp, backbone, root):
    """Phase 14. Returns the runs' launches by path, the measurements and
    the baseline's experiment directory (its npz files written)."""
    from tedm_tpu_torch.eval import run_tests, testing_shared_weights

    runs, report = [], {}
    head = ["--saved_diffusion_model", backbone, "--n_labelled_images", "1"]
    tedm, counts, report["TEDM step ms"] = corpus_run(tmp, root, "TEDM head", ["--experiment", "TEDM"] + head)
    runs.append(("TEDM head (corpus)", counts))
    pddm, counts, report["PDDM step ms"] = corpus_run(
        tmp, root, "PDDM probe", ["--experiment", "PDDM", "--t_steps_to_save", "1"] + head)
    runs.append(("PDDM probe training", counts))
    base, counts, report["baseline n=1 step ms"] = corpus_run(
        tmp, root, "baseline n=1", ["--experiment", "baseline", "--n_labelled_images", "1"], backward=True)
    runs.append(("baseline training n=1", counts))
    for mixed in (False, True):
        for flags in ((), ("--use_pallas_resblock", "--use_pallas_flash"), ("--use_pallas_groupnorm",)):
            if mixed and flags == ("--use_pallas_groupnorm",):
                continue
            label = f"{label_of(mixed, flags)}baseline"
            _, counts, report[f"{label} step ms (batch 16)"] = corpus_run(
                tmp, root, label, ["--experiment", "baseline", "--n_labelled_images", "197"], mixed, flags, backward=True)
            runs.append((f"{label} training", counts))
            baseline_step_card_vs_cpu(root, mixed, flags)
    for name, cli, exp_dir in (("TEDM", testing_shared_weights, tedm), ("baseline", run_tests, base),
                               ("PDDM", run_tests, pddm)):
        counts, report[f"{name} eval"] = evaluate(name, cli, exp_dir, root)
        runs.append((f"{name} eval", counts))
    report["tables"] = paper_table(os.path.join(tmp, "eval_logs"))
    return runs, report, base


def paper_table(logs) -> list:
    """The port's ``reporting.tables`` over phase 14's npz files (Dice x100,
    n = 1): its main-table rows, each with a number."""
    from tedm_tpu_torch.reporting import tables

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        tables.main(["--logs", logs, "--experiments", "baseline", "TEDM", "PDDM", "--datasizes", "1"])
    table = [line for line in text.getvalue().splitlines() if not line.startswith("Experiment ")]
    rows = [line for line in table if line.endswith("\\\\")]
    print("phase 14 reporting.tables over the eval files (Dice x100 mean $\\pm$ std at n = 1, by set):\n"
          + "\n".join(table), flush=True)
    if len(rows) != 9 or any(row.split("&")[1].strip() == "--" for row in rows):
        fail(f"phase 14: reporting.tables printed {rows}")
    return rows


# ------------------------------------------------------------------ phase 15

def cl_pretrain(tmp, experiment, argv=()):
    """global_cl or local_cl through train.main on synthetic CXR14: CL_STEPS
    steps at batch 16 (32 views) and one validation of CL_VAL_BATCHES
    batches. Held: the steps, the validation, the checkpoint and the
    launches (GlobalCL 4 B.1 + 4 B.1b a step, LocalCL 6 + 2; 4 or 6 B.1 a
    val batch). Returns the checkpoint, the launches and the measurements."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.train import main as train_main

    argv = ["--experiment", experiment, "--synthetic_data", "--seed", str(SEED), "--max_steps", str(CL_STEPS),
            "--val_freq", str(CL_STEPS), "--max_val_steps", str(CL_VAL_BATCHES), "--log_freq", "1",
            "--log_dir", os.path.join(tmp, "cl", experiment), *argv]
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
    losses = [r["train/loss"] for r in steps]
    median = statistics.median(step_ms[1:])
    fwd, bwd = (4, 4) if experiment == "global_cl" else (6, 2)
    expected = launches(linear_attention=fwd * (CL_STEPS + CL_VAL_BATCHES), linear_attention_backward=bwd * CL_STEPS)
    print(f"{experiment}: {len(steps)} steps at batch {cfg.batch_size} ({2 * cfg.batch_size} views), "
          f"{cfg.img_size}^2, fp32, {wall:.1f} s wall with validation; step ms {[round(x, 1) for x in step_ms]}; "
          f"median of steps 2-{len(steps)} {median:.3f} ms = {1e3 * cfg.batch_size / median:.2f} images/s "
          f"({2e3 * cfg.batch_size / median:.2f} views/s); losses {[round(x, 4) for x in losses]}; val loss {val}; "
          f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); launches "
          f"{({k: v for k, v in counts.items() if v})} ({fwd} B.1 + {bwd} B.1b a step, {fwd} B.1 a val batch)",
          flush=True)
    if len(steps) != CL_STEPS or len(val) != 1 or not all(math.isfinite(x) for x in losses + val):
        fail(f"{experiment}: {len(steps)} steps, losses {losses}, val {val}")
    if counts != expected:
        fail(f"{experiment}: launches {counts}, expected {expected}")
    best = os.path.join(cfg.log_dir, "best")
    if not os.path.isfile(os.path.join(best, "state.pt")):
        fail(f"{experiment} wrote no best checkpoint")
    return best, counts, {"step_ms": median, "images_per_s": 1e3 * cfg.batch_size / median, "peak_bytes": peak,
                          "wall_s": wall, "losses": losses, "val_loss": val[0]}


def cl_step_card_vs_cpu(experiment):
    """One CL step at batch 2 (4 views, made on the host from the seed) on
    the card and on the CPU plain path, from the same weights (initialised
    from the seed) and, for LocalCL, the same region centres: the loss and
    the gradient of every trained tensor, at phase 6's gates."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
    from tedm_tpu_torch.models.contrastive import region_centres
    from tedm_tpu_torch.ops.augment import augment_and_concat
    from tedm_tpu_torch.trainers import contrastive
    from tedm_tpu_torch.trainers.common import to_nchw

    cfg = config_from_args(["--experiment", experiment, "--seed", str(SEED),
                            "--log_dir", os.path.join(tempfile.gettempdir(), "unused")])
    data = SyntheticCXRDataset("cxr_train", 2, cfg.img_size, labelled=False, seed=SEED)
    gen = torch.Generator().manual_seed(SEED)
    views = augment_and_concat(to_nchw(np.stack([data[i] for i in range(2)]), "cpu"), gen)
    side = cfg.img_size * 4 // 2 ** (len(cfg.dim_mults) - 1)  # LocalCL's features: two stages up from the mid
    centres = region_centres(side, side, gen) if experiment == "local_cl" else None
    results = {}
    for device in ("cuda", "cpu"):
        model = contrastive.build_model(cfg, device)
        optimizer = torch.optim.Adam(contrastive.trainable_parameters(model), lr=cfg.lr)
        steps = contrastive.make_steps(cfg, model, optimizer)
        loss = steps.train_step(None, views=views.to(device), centres=centres)
        results[device] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None})
    (loss_g, grads_g), (loss_c, grads_c) = results["cuda"], results["cpu"]
    if sorted(grads_g) != sorted(grads_c):
        fail(f"{experiment}: gradients of other tensors on the card and on the CPU")
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    grad_errs = {n: rel_err(grads_g[n], grads_c[n]) for n in grads_c}
    worst = max(grad_errs, key=grad_errs.get)
    print(f"{experiment} step at batch 2 (4 views), card vs CPU plain path: loss {loss_g:.6f} vs {loss_c:.6f} "
          f"(relative {loss_err:.2e}, tol {STEP_LOSS_TOL}); gradients of {len(grad_errs)} tensors, worst relative "
          f"to the tensor's largest entry {grad_errs[worst]:.2e} at {worst} (tol {STEP_GRAD_TOL}), median "
          f"{statistics.median(grad_errs.values()):.2e}", flush=True)
    if not (math.isfinite(loss_g) and loss_err <= STEP_LOSS_TOL and grad_errs[worst] <= STEP_GRAD_TOL):
        fail(f"the {experiment} step on the card disagrees with the CPU plain path")
    return {"loss_rel_err": loss_err, "worst_grad_rel_err": grad_errs[worst]}


def cl_predictor(logs, size):
    """One Predictor("Global & Local CL") request on the card (8 B.1
    launches) against the CPU plain path, at PATH_TOL."""
    from tedm_tpu_torch.serve.app import Predictor

    img = np.random.RandomState(SEED).rand(1, 128, 128, 1).astype(np.float32)
    predictor = eager_predictor(logs)
    predictor.predict(img, "Global & Local CL", size)  # the first request loads the checkpoint
    reset_launches()
    t0 = time.perf_counter()
    mask = predictor.predict(img, "Global & Local CL", size)
    latency = 1e3 * (time.perf_counter() - t0)
    counts = read_launches()
    probs = predictor._probabilities(img, "Global & Local CL", size)
    probs_cpu = Predictor(logs_root=logs, device="cpu")._probabilities(img, "Global & Local CL", size)
    err = float(np.abs(probs - probs_cpu).max())
    print(f"Predictor(\"Global & Local CL\"): one request {latency:.3f} ms, mask foreground {mask.mean():.4f}, "
          f"launches {({k: v for k, v in counts.items() if v})}; card vs CPU plain path max_abs_err {err:.3e} "
          f"(tol {PATH_TOL})", flush=True)
    if counts != per_unet_call(False) or mask.shape != (128, 128) or not err <= PATH_TOL:
        fail(f"Predictor(\"Global & Local CL\"): launches {counts}, mask {mask.shape}, card vs CPU {err}")
    return counts, {"latency_ms": latency, "max_abs_err": err}


def contrastive_arms(tmp, root):
    """Phase 15. Returns the runs' launches by path and the measurements."""
    from tedm_tpu_torch.eval import run_tests

    runs, report = [], {}
    g_best, counts, report["global_cl"] = cl_pretrain(tmp, "global_cl")
    runs.append(("global_cl pretraining", counts))
    report["global_cl"]["card_vs_cpu"] = cl_step_card_vs_cpu("global_cl")
    l_best, counts, report["local_cl"] = cl_pretrain(tmp, "local_cl", ["--global_model_path", g_best])
    runs.append(("local_cl pretraining", counts))
    report["local_cl"]["card_vs_cpu"] = cl_step_card_vs_cpu("local_cl")
    finetune = ["--n_labelled_images", "197", "--unfreeze_weights_at_step", "3", "--augment_at_finetuning"]
    glob_loc = ["--experiment", "glob_loc_finetune", "--glob_loc_model_path", l_best] + finetune
    glob = ["--experiment", "global_finetune", "--global_model_path", g_best] + finetune
    opt_in = ("--use_pallas_resblock", "--use_pallas_flash")
    exp_dir = None
    # the fp32 glob_loc_finetune run first: run_tests and Predictor read it
    for argv, mixed, flags in ((glob_loc, False, ()), (glob_loc, True, ()), (glob, False, ()), (glob, True, ()),
                               (glob, False, opt_in)):
        label = f"{label_of(mixed, flags)}{argv[1]}"
        run_dir, counts, ms = corpus_run(tmp, root, label, argv, mixed, flags, backward=True)
        exp_dir = exp_dir or run_dir
        report[label] = {"step_ms": ms, "images_per_s": 16e3 / ms,
                         "card_vs_cpu": baseline_step_card_vs_cpu(root, mixed, flags, argv)}
        runs.append((f"{label} training", counts))
    counts, report["glob_loc_finetune eval"] = evaluate("glob_loc_finetune", run_tests, exp_dir, root)
    runs.append(("glob_loc_finetune eval", counts))
    counts, report["Global & Local CL request"] = cl_predictor(os.path.join(tmp, "eval_logs"), 197)
    runs.append(("Global & Local CL serving", counts))
    return runs, report


# ------------------------------------------------------------------ phase 16

def conditional_chain(tmp, root):
    """Phase 16: a conditional backbone through train.main on the corpus's
    JSRT files (COND_STEPS steps at batch 16, one validation with its
    1000-step sample grid), run_tests on it with --ddim_steps DDIM_STEPS
    over the four sets (seconds, images/s, 8 B.1 a UNet call), and one DDIM
    (eta 0) and one DPM-Solver++(2M) trajectory of one image on the card
    against the CPU plain path from the same x_T. Returns the runs'
    launches by path and the measurements."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.eval import harness as H
    from tedm_tpu_torch.eval import run_tests
    from tedm_tpu_torch.models.diffusion import ddim_sample_loop, dpmpp2m_sample_loop
    from tedm_tpu_torch.train import main as train_main

    argv = ["--experiment", "conditional", "--data_dir", os.path.join(root, "JSRT"), "--splits_dir",
            os.path.join(root, "data"), "--seed", str(SEED), "--ema_decay", "0.999", "--max_steps", str(COND_STEPS),
            "--val_freq", str(COND_STEPS), "--max_val_steps", "1", "--log_freq", "1",
            "--log_dir", os.path.join(tmp, "cond", "run")]
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
    median = statistics.median(step_ms[1:])
    # one val batch: val_loss in chunks of 8 timesteps and the sample grid's T calls
    n_t = len(range(0, cfg.timesteps, max(cfg.timesteps // cfg.val_steps, 1)))
    val_calls = math.ceil(n_t / 8) + cfg.timesteps
    expected = launches(linear_attention=8 * (COND_STEPS + val_calls), linear_attention_backward=8 * COND_STEPS)
    print(f"conditional backbone: {len(steps)} steps at batch {cfg.batch_size}, {wall:.1f} s wall with validation; "
          f"step ms {[round(x, 1) for x in step_ms]}; median of steps 2-{len(steps)} {median:.3f} ms = "
          f"{1e3 * cfg.batch_size / median:.2f} images/s; val loss {val}; peak device memory {peak} bytes "
          f"({peak / 2**30:.3f} GiB); launches {({k: v for k, v in counts.items() if v})}", flush=True)
    if len(steps) != COND_STEPS or len(val) != 1 or not all(math.isfinite(x) for x in val):
        fail(f"conditional backbone: {len(steps)} steps, val {val}")
    if counts != expected:
        fail(f"conditional backbone: launches {counts}, expected {expected}")
    runs = [("conditional training", counts)]
    report = {"train": {"step_ms": median, "images_per_s": 1e3 * cfg.batch_size / median, "peak_bytes": peak}}

    reset_launches()
    marks = Marks()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(marks):
        run_tests.main(["--experiment", cfg.log_dir, "--nih_path", os.path.join(root, "NIH"), "--mon_path",
                        os.path.join(root, "Montgomery"), "--ddim_steps", str(DDIM_STEPS)], device="cuda")
    torch.cuda.synchronize()
    end = time.perf_counter()
    counts = read_launches()
    calls = sum(math.ceil(n / 16) for n in EVAL_SETS.values()) * EVAL_RUNS * DDIM_STEPS
    per_set = per_set_times(marks, end)
    images = sum(EVAL_SETS.values())
    dice = check_npz("conditional", cfg.log_dir)
    by_set = ", ".join(f"{k} {v['seconds']:.3f} s" for k, v in per_set.items())
    print(f"conditional eval (DDIM {DDIM_STEPS} steps, {EVAL_RUNS} runs a batch): {images} images of 4 sets in "
          f"{end - t0:.2f} s = {images / (end - t0):.2f} images/s, of which the checkpoint load and loaders "
          f"{marks.marks[0][1] - t0:.2f} s; by set {by_set}; {calls} UNet calls, launches "
          f"{({k: v for k, v in counts.items() if v})}; mean Dice {dice}", flush=True)
    if sorted(per_set) != sorted(EVAL_SETS) or counts != launches(linear_attention=8 * calls):
        fail(f"conditional eval: sets {sorted(per_set)}, launches {counts}, expected {8 * calls} B.1")
    runs.append(("conditional eval", counts))
    report["eval"] = {"seconds": end - t0, "images_per_s": images / (end - t0), "per_set": per_set,
                      "unet_calls": calls, "dice": dice}

    # one trajectory of one image, card vs CPU, from the same x_T
    batch = next(iter(H.build_jsrt_loaders(cfg)["val"]))
    x_T = torch.from_numpy(np.random.RandomState(SEED).randn(1, 1, 128, 128).astype(np.float32))
    gaps = {}
    for name, loop in (("ddim", ddim_sample_loop), ("dpmpp2m", dpmpp2m_sample_loop)):
        out = {}
        for device in ("cuda", "cpu"):
            _, unet, sched = H.load_diffusion_experiment(cfg.log_dir, device)
            cond = torch.from_numpy(batch["image"][:1]).permute(0, 3, 1, 2).contiguous().to(device) * 2 - 1
            with torch.inference_mode():
                out[device] = loop(lambda x, t: unet(torch.cat([x, cond], dim=1), t), sched, (1, 1, 128, 128),
                                   num_steps=DDIM_STEPS, x_T=x_T.to(device)).cpu()
        gaps[name] = (out["cuda"] - out["cpu"]).abs().max().item()
        print(f"{name} trajectory ({DDIM_STEPS} steps, one image), card vs CPU plain path: max_abs_err "
              f"{gaps[name]:.3e} (tol {SAMPLER_TOL}); sample in [{out['cuda'].min():.4f}, {out['cuda'].max():.4f}]",
              flush=True)
        if not (torch.isfinite(out["cuda"]).all() and gaps[name] <= SAMPLER_TOL):
            fail(f"the {name} trajectory on the card disagrees with the CPU plain path: {gaps[name]}")
    report["trajectory_max_abs_err"] = gaps
    return runs, report, cfg.log_dir


# ------------------------------------------------------------------ phase 17

GRAPH_TOL = 1e-6             # graphed and exported probabilities against eager ones (bitwise expected)
GRAPH_REQUESTS = 6           # requests a predictor: the first eager (the graph's warm-up, then its capture)
REMAT_STEPS = 4              # path (a) steps of each --remat run
PROFILE_STEPS = 16           # path (a) steps of the --profile_dir run (steps 10-15 traced)
EXPORT_STEPS = 2             # steps of the exported DDIM and DPM++ samplers (export and load scale with it)
ANCESTRAL_GRID = 10          # the trajectory's last steps that the exported ancestral step runs
RF = ("--use_pallas_resblock", "--use_pallas_flash")
# the kernels of which each call launches ``per``, by short name: a call's mark in a trace
CALL_MARKS = {"linear_attention": (("la_cluster", "context_chunks"), 1), "linear_attention_backward": (("grad_q",), 1),
              "prenorm_linear_attention": (("apply_block",), 1), GN: (("gn_cluster", "gn_apply"), 1),
              RB: (("gn_coefs",), 2), RBB: (("gn_bwd_coefs",), 2), FA: (("flash_row", "flash_fwd"), 1)}
OPS = {"linear_attention": "tedm_tpu_torch::linear_attention",
       "prenorm_linear_attention": "tedm_tpu_torch::prenorm_linear_attention",
       GN: "tedm_tpu_torch::group_norm_film_silu", RB: "tedm_tpu_torch::resnet_block",
       FA: "tedm_tpu_torch::cosine_attention"}


def calls_in_trace(kernels) -> dict:
    """Each kernel's calls among the device kernels of a trace (full names),
    counted by the kernels that mark a call: what ran on the card, graphed
    or not, whatever the host counters say."""
    names = collections.Counter(short_name(k) for k in kernels)
    return launches(**{k: sum(names[n] for n in marks) // per for k, (marks, per) in CALL_MARKS.items()})


def no_pallas_serving(tmp, served, served16):
    """``--no_pallas``: phase 4's weights served in fp32 and bf16 under the
    flag (``serve``: no B.1 or B.2 launch a request, the card against the
    CPU), the probabilities within the path gate of the default path's."""
    runs, report = [], {}
    for mixed, ref in ((False, served), (True, served16)):
        run = serve(tmp, mixed, ("--no_pallas",), flag_off=ref)
        diff = float(np.abs(run["probs"] - ref["probs"]).max())
        tol = BF16_PATH_TOL if mixed else PATH_TOL
        label = label_of(mixed, ("--no_pallas",))
        print(f"{label}request {run['latency_ms']:.3f} ms against the default path's {ref['latency_ms']:.3f} ms; "
              f"probabilities max_abs_diff {diff:.3e} (tol {tol})", flush=True)
        if not diff <= tol:
            fail(f"{label}probabilities differ from the default path's by {diff}")
        report[label.strip()] = {"latency_ms": run["latency_ms"], "default_latency_ms": ref["latency_ms"],
                                 "max_abs_diff": diff}
        runs.append((f"{label}serving", run["launches"]))
    return runs, report


def graphed_serving(tmp):
    """CUDA-graph replay in Predictor, for fp32 and bf16, default and
    resblock + flash (phases 4, 8 and 12's checkpoints): host latency of
    ``GRAPH_REQUESTS`` requests, graphed against eager; the busy share of
    one request of each under torch.profiler; a replay's kernel calls
    counted from its trace (``calls_in_trace``) equal to a UNet call's; the
    graphed probabilities of the folded rows equal to the eager ones, with
    the NOISE_SEED draw and with caller noise; then peak memory with the 4
    models' graphs in one Predictor (one shared pool)."""
    import gc

    from tedm_tpu_torch.serve.app import Predictor

    rs = np.random.RandomState(SEED + 17)
    imgs = [rs.rand(1, 128, 128, 1).astype(np.float32) for _ in range(GRAPH_REQUESTS)]
    noise = rs.randn(1, 128, 128, 1).astype(np.float32)
    runs, report = [], {}
    for mixed, flags in ((False, ()), (True, ()), (False, RF), (True, RF)):
        label = label_of(mixed, flags)
        logs = serve_logs(tmp, mixed, flags)
        per = per_unet_call(mixed, flags)
        row = {}
        predictors = {"eager": eager_predictor(logs), "graphed": Predictor(logs, "cuda")}
        for name, pred in predictors.items():
            reset_launches()
            times = []
            for img in imgs:
                t0 = time.perf_counter()
                pred.predict(img, "TEDM", 1)  # host numpy: synchronised
                times.append(1e3 * (time.perf_counter() - t0))
            counts = read_launches()
            # host counters: every eager request; the graph's warm-up and capture, no replay
            want = {k: v * (GRAPH_REQUESTS if name == "eager" else 2) for k, v in per.items()}
            if counts != want:
                fail(f"{label}{name} requests: host launches {counts}, expected {want}")
            if name == "eager":
                runs.append((f"{label}serving (phase 17, eager)", counts))
            profile(f"one {name} {label}request", lambda: pred.predict(imgs[0], "TEDM", 1))
            # the kernels of one request, from a session of several (one session can lose an event)
            calls = calls_in_trace(n for n, _ in call_launches(f"{name} {label}request",
                                                                lambda: pred.predict(imgs[0], "TEDM", 1), calls=4))
            if calls != per:
                fail(f"one {name} {label}request ran the kernels' calls {calls} on the card, expected {per}")
            row[name] = {"latency_ms": times, "median_ms": statistics.median(times[1:]), **profile.last}
        eager, graphed = predictors["eager"], predictors["graphed"]
        if not graphed._graphs:
            fail(f"{label}Predictor captured no graph")
        gaps = {}
        for what, kw in (("NOISE_SEED draw", {}), ("caller noise", {"noise": noise})):
            pe = eager._probabilities(imgs[1], "TEDM", 1, mean=False, **kw)
            pg = graphed._probabilities(imgs[1], "TEDM", 1, mean=False, **kw)
            gaps[what] = float(np.abs(pg - pe).max())
            if pg.shape != (8, 128, 128, 1) or not gaps[what] <= GRAPH_TOL:
                fail(f"{label}graphed probabilities ({what}) differ from eager ones by {gaps[what]}")
        row["graphed_vs_eager_max_abs"] = gaps
        print(f"{label}requests, median of 2-{GRAPH_REQUESTS}: graphed {row['graphed']['median_ms']:.3f} ms "
              f"(device busy {row['graphed']['busy_ms']:.3f} of {row['graphed']['wall_ms']:.3f} ms) against eager "
              f"{row['eager']['median_ms']:.3f} ms (busy {row['eager']['busy_ms']:.3f} of {row['eager']['wall_ms']:.3f}); "
              f"a replay's calls on the card {({k: v for k, v in per.items() if v})}; graphed vs eager {gaps}",
              flush=True)
        report[label.strip() or "fp32"] = row
        del predictors, eager, graphed, pred
    gc.collect()
    torch.cuda.empty_cache()

    # the 4 models' graphs in one predictor: TEDM sizes 1, 3, 6, 12 are the 4 checkpoints
    root = os.path.join(tmp, "graphs", "logs")
    for size, (mixed, flags) in zip((1, 3, 6, 12), ((False, ()), (True, ()), (False, RF), (True, RF))):
        os.makedirs(os.path.join(root, "TEDM"), exist_ok=True)
        os.symlink(os.path.join(serve_logs(tmp, mixed, flags), "TEDM", "1"), os.path.join(root, "TEDM", str(size)))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pred = Predictor(root, "cuda")
    for size in (1, 3, 6, 12):
        for img in imgs[:2]:
            pred.predict(img, "TEDM", size)
    peak, held = torch.cuda.max_memory_allocated() - before, torch.cuda.memory_allocated() - before
    print(f"4 graphed models in one Predictor (one pool): peak device memory {peak} bytes ({peak / 2**30:.3f} GiB) "
          f"above the {before / 2**30:.3f} GiB held before, {held / 2**30:.3f} GiB held after", flush=True)
    if len(pred._graphs) != 4:
        fail(f"the predictor holds {len(pred._graphs)} graphs, expected 4")
    report["four_graphed_models"] = {"peak_bytes": peak, "held_bytes": held}
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    return runs, report


EXPORTED_CALL = """
import json, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
from tedm_tpu_torch.serve.export import load_exported

kernels = {"linear_attention": "linear_attention", "prenorm_linear_attention": "attn_block",
           "fused_group_norm_film_silu": "groupnorm", "fused_resnet_block": "resblock",
           "flash_cosine_attention": "flash_attention"}
layouts = ("prenorm_linear_attention", "fused_resnet_block")  # the kernels that lay weights out
wrapper = lambda k: getattr(sys.modules.get("tedm_tpu_torch.kernels." + kernels[k]), k, None)
built = lambda: {k: getattr(wrapper(k), "layouts_built", 0) for k in layouts}
x = np.load(sys.argv[1])
secs = {"import": time.perf_counter() - t0}
for path, y_path in zip(sys.argv[2::2], sys.argv[3::2]):
    t0 = time.perf_counter()
    call = load_exported(path)
    secs["load"] = time.perf_counter() - t0
    before = built()
    call(x)  # the first call lays the baked weights out for the kernels
    secs["first_call"] = time.perf_counter() - t0 - secs["load"]
    first = built()
    for k in kernels:
        if wrapper(k) is not None:
            wrapper(k).launches = 0
    np.save(y_path, call(x))
    second = built()
    print(json.dumps({"launches": {k: 0 if wrapper(k) is None else wrapper(k).launches for k in kernels},
                      "layouts_first": {k: first[k] - before[k] for k in layouts},
                      "layouts_second": {k: second[k] - first[k] for k in layouts}, "seconds": secs}), flush=True)
    secs = {}
"""
EXPORTED = ((False, ()), (True, ()), (True, RF))  # phase 4's, 8's and 12's TEDM checkpoints
EXPORT_ALL = """
import json, sys, time
from tedm_tpu_torch.serve.export import export_predictor, export_sampler
from tedm_tpu_torch.utils.device import strict_fp32

strict_fp32()
steps = int(sys.argv[1])
for kind, run, sampler, path in zip(*[iter(sys.argv[2:])] * 4):
    t0 = time.perf_counter()
    if kind == "predictor":
        size = export_predictor(run, path, device="cuda")
    else:
        size = export_sampler(run, path, sampler=sampler, num_steps=steps, device="cuda")
    print("EXPORTED", json.dumps({"path": path, "bytes": size, "export_s": time.perf_counter() - t0}), flush=True)
"""


class Exports:
    """Phase 17's artifacts, exported by processes of their own, started at
    the phase's start: torch.export takes ~10 s of host time a traced UNet
    call and holds its process's interpreter, so the exports run beside
    this process's serving, training and checks, in three processes:
    ``export_predictor`` of phase 4's TEDM checkpoint in fp32 and bf16 and
    of phase 12's bf16 resblock + flash one; and ``export_sampler`` of
    ``samplers``' runs, in two halves. ``result(path)`` waits for an
    artifact and returns its bytes and its seconds of export."""

    def __init__(self, tmp, samplers):
        name = lambda mixed, flags: label_of(mixed, flags).strip().replace(" ", "_") or "fp32"
        self.predictors = [(mixed, flags, os.path.join(tmp, f"tedm_{name(mixed, flags)}.pt2")) for mixed, flags in EXPORTED]
        self.samplers = [(run, sampler, os.path.join(tmp, f"sampler_{i}_{sampler}.pt2"))
                         for i, (run, sampler) in enumerate(samplers)]
        jobs = [[("predictor", os.path.join(serve_logs(tmp, mixed, flags), "TEDM", "1"), "-", path)
                 for mixed, flags, path in self.predictors]]
        half = (len(self.samplers) + 1) // 2
        jobs += [[("sampler", *row) for row in part] for part in (self.samplers[:half], self.samplers[half:])]
        env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
        self.procs, self.owner, self.done = [], {}, {}
        for i, job in enumerate(jobs):
            err = os.path.join(tmp, f"exports_{i}.err")
            with open(err, "w") as f:
                argv = [sys.executable, "-c", EXPORT_ALL, str(EXPORT_STEPS), *(a for row in job for a in row)]
                proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=f, text=True, env=env)
            self.procs.append((proc, err))
            self.owner.update({row[-1]: i for row in job})

    def result(self, path):
        proc, err = self.procs[self.owner[path]]
        while path not in self.done:
            line = proc.stdout.readline()
            if not line:
                proc.wait()
                with open(err) as f:
                    fail(f"an export process ended (code {proc.returncode}) before {path}:\n{f.read()[-3000:]}")
            if line.startswith("EXPORTED "):  # the loaders print too
                row = json.loads(line[len("EXPORTED "):])
                self.done[row["path"]] = row
        return self.done[path]["bytes"], self.done[path]["export_s"]

    def close(self):
        for proc, _ in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def export_predictors(tmp, exports):
    """Phase 4's, 8's and 12's TEDM predictors as ``exports`` wrote them,
    then one fresh process, started here and left running, that imports
    only torch and ``tedm_tpu_torch.serve.export`` and loads and calls each
    twice. Returns what ``check_exported_predictors`` reads."""
    img = np.random.RandomState(SEED + 18).rand(1, 128, 128, 1).astype(np.float32)
    x_path = os.path.join(tmp, "export_x.npy")
    np.save(x_path, img.transpose(0, 3, 1, 2))
    rows, args = [], []
    for mixed, flags, path in exports.predictors:
        want = eager_predictor(serve_logs(tmp, mixed, flags))._probabilities(img, "TEDM", 1, mean=False)
        size, export_s = exports.result(path)
        rows.append((mixed, flags, size, export_s, want, path + ".y.npy"))
        args += [path, path + ".y.npy"]
    env = {**os.environ, "PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    proc = subprocess.Popen([sys.executable, "-c", EXPORTED_CALL, x_path, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    return rows, proc, time.perf_counter()


def check_exported_predictors(rows, proc, started):
    """The fresh process's outputs equal ``Predictor._probabilities`` before
    the mean; the second call of each launched the kernels of one UNet call
    (host counters of that process) and laid no weight out: the first call
    of a loaded program lays out its baked weights (B.2's fragments, B.4's
    tiles), once."""
    out, err = proc.communicate()
    process_s = time.perf_counter() - started
    if proc.returncode != 0:
        fail(f"the exported predictors failed in a fresh process:\n{err[-3000:]}")
    lines = [json.loads(line) for line in out.strip().splitlines()[-len(rows):]]
    runs, report = [], {}
    for (mixed, flags, size, export_s, want, y_path), line in zip(rows, lines):
        label = label_of(mixed, flags)
        counts, first, second = line["launches"], line["layouts_first"], line["layouts_second"]
        got = np.load(y_path).transpose(0, 2, 3, 1)
        gap = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        expected = {k: v for k, v in per_unet_call(mixed, flags).items() if k in counts}
        secs = {k: round(v, 1) for k, v in line["seconds"].items()}
        print(f"exported {label}predictor: {size} bytes, exported in {export_s:.1f} s (the export process); called "
              f"in a fresh process (the artifacts loaded and called twice in {process_s:.1f} s, beside the other "
              f"checks; this one's seconds {secs}): output "
              f"{got.shape} against Predictor's folded rows: max_abs_err {gap:.3e} (tol {GRAPH_TOL}); launches of "
              f"its second call {counts}; weight layouts built by the first call {first}, by the second {second}",
              flush=True)
        if not gap <= GRAPH_TOL or counts != expected:
            fail(f"exported {label}predictor: max_abs_err {gap}, launches {counts}, expected {expected}")
        if any(second.values()) or any(bool(first[k]) != bool(counts[k]) for k in first):
            fail(f"exported {label}predictor: weight layouts built {first} by the first call and {second} by the "
                 f"second; expected some by the first for each kernel that launched, none by the second")
        report[f"{label}predictor".strip()] = {"bytes": size, "export_s": export_s, "max_abs_err": gap, "seconds": secs,
                                               "layouts_first_call": first}
        runs.append((f"exported {label}predictor (fresh process)", launches(**counts)))
    report["fresh_process_s"] = process_s
    return runs, report


def layouts_built() -> dict:
    """How many weight layouts B.2 and B.4 have built in this process."""
    from tedm_tpu_torch.kernels import attn_block, resblock

    return {"prenorm_linear_attention": attn_block.prenorm_linear_attention.layouts_built,
            RB: resblock.fused_resnet_block.layouts_built}


def exported_samplers(exports):
    """``export_sampler`` (``exports``) for phase 5's img_only backbone (DDIM,
    and the ancestral step over the trajectory's last ``ANCESTRAL_GRID``
    steps), phase 9's bf16 one (the ancestral step) and phase 16's
    conditional backbone (DPM++), each called twice: the second call
    against the eager loop from the same noise at ``SAMPLER_TOL``, its
    kernel launches counted, and no weight laid out again after the first."""
    from tedm_tpu_torch.eval.harness import load_diffusion_experiment
    from tedm_tpu_torch.models import diffusion as D
    from tedm_tpu_torch.serve.export import load_exported

    runs, report = [], {}
    rs = np.random.RandomState(SEED + 19)
    for run, sampler, path in exports.samplers:
        config, unet, sched = load_diffusion_experiment(run, "cuda")
        label = f"{label_of(config.mixed_precision)}{sampler}"
        size, export_s = exports.result(path)
        call = load_exported(path)
        x_T = torch.from_numpy(rs.randn(1, 1, 128, 128).astype(np.float32)).cuda()
        cond = None
        if config.experiment == "conditional":
            cond = torch.from_numpy(rs.rand(1, 1, 128, 128).astype(np.float32) * 2 - 1).cuda()
        apply = unet if cond is None else (lambda x, t: unet(torch.cat([x, cond], dim=1), t))
        kw = dict(objective=config.objective, dynamic_threshold_percentile=config.dynamic_threshold_percentile)
        extra = () if cond is None else (cond,)
        with torch.inference_mode():
            if sampler == "ancestral":
                grid = list(range(ANCESTRAL_GRID - 1, -1, -1))
                noises = torch.from_numpy(rs.randn(ANCESTRAL_GRID, 1, 1, 128, 128).astype(np.float32)).cuda()
                x, calls = x_T, ANCESTRAL_GRID
                for i, t in enumerate(grid):
                    x = D.sample_step(apply, sched, x, torch.full((1,), t, device="cuda"), noise=noises[i], **kw)
                run_program = lambda: call(x_T, noises, *extra, grid=grid)
            else:
                loop = D.ddim_sample_loop if sampler == "ddim" else D.dpmpp2m_sample_loop
                x, calls = loop(apply, sched, x_T.shape, num_steps=EXPORT_STEPS, x_T=x_T, **kw), EXPORT_STEPS
                run_program = lambda: call(x_T, *extra)
            before = layouts_built()
            run_program()  # the first call lays the baked weights out
            first = layouts_built()
            reset_launches()
            got = run_program()
            counts, second = read_launches(), layouts_built()
            want = D.unnormalize_to_zero_to_one(x.clamp(-1.0, 1.0)).cpu().numpy()
        first = {k: v - before[k] for k, v in first.items()}
        second = {k: v - first[k] - before[k] for k, v in second.items()}
        err = float(np.abs(got - want).max())
        expected = {k: v * calls for k, v in per_unet_call(config.mixed_precision).items()}
        print(f"exported {label} sampler of the {config.experiment} backbone: {size} bytes, exported in "
              f"{export_s:.1f} s (the export process); against the eager loop from the same noise ({calls} UNet calls): max_abs_err "
              f"{err:.3e} (tol {SAMPLER_TOL}); launches {({k: v for k, v in counts.items() if v})}; weight layouts "
              f"built by the first call {first}, by the second {second}", flush=True)
        if not err <= SAMPLER_TOL or counts != expected:
            fail(f"exported {label} sampler: max_abs_err {err}, launches {counts}, expected {expected}")
        if any(second.values()) or any(bool(first[k]) != bool(counts[k]) for k in first):
            fail(f"exported {label} sampler: weight layouts built {first} by the first call and {second} by the "
                 f"second; expected some by the first for each kernel that launched, none by the second")
        report[f"{config.experiment} {label}"] = {"bytes": size, "export_s": export_s, "max_abs_err": err,
                                                  "unet_calls": calls, "layouts_first_call": first}
        runs.append((f"exported {label} sampler", counts))
    return runs, report


def serve_grid(tmp):
    """``predict``, the grid, over phases 14-15's checkpoints: Baseline,
    TEDM and PDDM at n = 1, and Baseline and the two CL finetunes at n =
    197, with ``seg_img`` off and on; its shape, and its seconds cold (the
    checkpoints loaded and the graphs captured) and warm."""
    from tedm_tpu_torch.serve.app import Predictor, predict

    img = (np.random.RandomState(SEED + 20).rand(160, 150) * 255).astype(np.uint8)
    predictor = Predictor(os.path.join(tmp, "eval_logs"), "cuda")
    report = {}
    for models, sizes in ((["TEDM", "PDDM", "Baseline"], [1]), (["Global & Local CL", "Baseline", "Global CL"], [197])):
        times = {}
        for what, seg in (("cold", False), ("warm", False), ("warm, seg_img", True)):
            t0 = time.perf_counter()
            grid = predict(img, models, sizes, seg, predictor=predictor)
            times[what] = time.perf_counter() - t0
            if grid.shape != (128 * len(models), 330, 3) or not np.isfinite(grid).all():
                fail(f"the grid of {models} x {sizes} has shape {grid.shape}")
        print(f"grid of {models} x {sizes}: {grid.shape}; seconds {({k: round(v, 3) for k, v in times.items()})}",
              flush=True)
        report[f"{'+'.join(models)} x {sizes}"] = times
    return report


def remat_runs(tmp):
    """``--remat``: path (a) steps in fp32, and with resblock + flash, with
    the flag and without it, through train.main (every block's forward runs
    twice a step: 16 B.1 and, with the flag, 2 x 19 B.4 a step); step time
    and peak memory of each; then one batch-16 step of each against the
    step without the flag on the same weights, t and noise, at the step
    gates."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.train import main as train_main
    from tedm_tpu_torch.trainers import diffusion as TD
    from tedm_tpu_torch.trainers.common import make_optimizer

    runs, report = [], {}
    for flags in ((), RF):
        for remat in (False, True):
            label = f"{label_of(False, flags)}path (a){' --remat' if remat else ''}"
            argv = ["--experiment", "img_only", "--synthetic_data", "--max_steps", str(REMAT_STEPS), "--val_freq",
                    str(100 * REMAT_STEPS), "--log_freq", "1", "--seed", str(SEED),
                    "--log_dir", os.path.join(tmp, "remat", label.replace(" ", "_")), *flags]
            argv += ["--remat"] if remat else []
            cfg = config_from_args(argv)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            train_main(argv, device="cuda")
            torch.cuda.synchronize()
            counts, peak = read_launches(), torch.cuda.max_memory_allocated()
            steps = [r for r in read_metrics(cfg.log_dir) if "train/loss" in r]
            median = statistics.median(1e3 * cfg.batch_size / r["train/imgs_per_sec"] for r in steps[1:])
            per = per_unet_call(False, flags, backward=True)
            want = {k: REMAT_STEPS * v * (2 if remat and k in (
                "linear_attention", RB, FA) else 1) for k, v in per.items()}
            print(f"{label}: {len(steps)} steps at batch {cfg.batch_size}, median of steps 2-{len(steps)} "
                  f"{median:.3f} ms; peak device memory {peak} bytes ({peak / 2**30:.3f} GiB); launches "
                  f"{({k: v for k, v in counts.items() if v})}", flush=True)
            if len(steps) != REMAT_STEPS or counts != want:
                fail(f"{label}: {len(steps)} steps, launches {counts}, expected {want}")
            report[label] = {"step_ms": median, "peak_bytes": peak}
            runs.append((f"{label_of(False, flags)}training (a){' --remat' if remat else ''}", counts))
        # one step with the flag against one without, from the same weights, batch, t and noise
        out = []
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.rand(16, 1, 128, 128, generator=gen, device="cuda")
        t = torch.randint(0, 1000, (16,), generator=gen, device="cuda")
        noise = torch.randn(16, 1, 128, 128, generator=gen, device="cuda")
        for remat in (False, True):
            cfg = config_from_args(["--experiment", "img_only", "--seed", str(SEED), *flags] + ["--remat"] * remat)
            unet = TD.build_model(cfg).cuda()
            steps = TD.make_steps(cfg, unet, make_schedule(cfg.timesteps, cfg.beta_schedule).to("cuda"),
                                  make_optimizer(cfg, unet.parameters()))
            loss, _ = steps.train_step(x, torch.zeros(1, device="cuda"), torch.ones(16, device="cuda"), t=t, noise=noise)
            out.append((float(loss), [p.grad for p in unet.parameters()]))
        loss_err = abs(out[1][0] - out[0][0]) / abs(out[0][0])
        grad_err = max(rel_err(a, b) for a, b in zip(out[1][1], out[0][1]))
        print(f"{label_of(False, flags)}--remat step against the step without it: loss {loss_err:.3e} relative "
              f"(tol {STEP_LOSS_TOL}), gradients {grad_err:.3e} of each largest entry (tol {STEP_GRAD_TOL})", flush=True)
        if not (loss_err <= STEP_LOSS_TOL and grad_err <= STEP_GRAD_TOL):
            fail(f"{label_of(False, flags)}--remat step: loss {loss_err}, gradients {grad_err}")
        report[f"{label_of(False, flags)}step vs --remat"] = {"loss_rel": loss_err, "grad_rel": grad_err}
        del out, unet, steps
    return runs, report


def profile_dir_run(tmp):
    """``--profile_dir``: a ``PROFILE_STEPS``-step path (a) run through
    train.main writes one trace of steps 10-15, and the trace holds the
    kernels of B.1 and B.1b."""
    from tedm_tpu_torch.train import main as train_main

    prof = os.path.join(tmp, "profile_dir")
    argv = ["--experiment", "img_only", "--synthetic_data", "--max_steps", str(PROFILE_STEPS), "--val_freq",
            str(100 * PROFILE_STEPS), "--log_freq", "4", "--seed", str(SEED),
            "--log_dir", os.path.join(tmp, "profile_run"), "--profile_dir", prof]
    reset_launches()
    t0 = time.perf_counter()
    train_main(argv, device="cuda")
    wall = time.perf_counter() - t0
    counts = read_launches()
    files = [os.path.join(d, f) for d, _, fs in os.walk(prof) for f in fs if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        fail(f"--profile_dir wrote {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    calls = calls_in_trace(kernels)
    b1, b1b = calls["linear_attention"], calls["linear_attention_backward"]
    size = os.path.getsize(files[0])
    print(f"--profile_dir: {PROFILE_STEPS} steps in {wall:.1f} s; trace {size} bytes, {len(kernels)} kernel "
          f"events, B.1 calls {b1}, B.1b calls {b1b} (6 steps: {6 * 8} each)", flush=True)
    # a profiler session can lose its first device event (torch.profiler on an H100)
    if not (6 * 8 - 1 <= b1 <= 6 * 8 and 6 * 8 - 1 <= b1b <= 6 * 8):
        fail(f"the --profile_dir trace holds {b1} B.1 and {b1b} B.1b calls, expected {6 * 8}")
    return [("training (a) --profile_dir", counts)], {"trace_bytes": size, "kernel_events": len(kernels),
                                                     "seconds": wall}


def phase_17(tmp, served, served16, backbone_dir, backbone16, cond_dir):
    """Phase 17. Returns the runs' launches by path and the measurements.
    ``backbone16`` is phase 9's last checkpoint, served as a run's best."""
    runs, report = [], {}
    backbone16_dir = os.path.join(tmp, "bf16_backbone")
    os.makedirs(backbone16_dir)
    os.symlink(os.path.abspath(backbone16), os.path.join(backbone16_dir, "best"))
    exports = Exports(tmp, ((backbone_dir, "ddim"), (backbone_dir, "ancestral"), (backbone16_dir, "ancestral"),
                            (cond_dir, "dpmpp")))
    exported = None
    try:
        parts = [("no_pallas", no_pallas_serving(tmp, served, served16)), ("graphs", graphed_serving(tmp))]
        exported = export_predictors(tmp, exports)  # their fresh process runs beside what follows
        parts += [("remat", remat_runs(tmp)), ("profile_dir", profile_dir_run(tmp))]
        report["grid"] = serve_grid(tmp)
        parts += [("exported_samplers", exported_samplers(exports)),
                  ("exported_predictor", check_exported_predictors(*exported))]
    finally:
        exports.close()
        if exported is not None and exported[1].poll() is None:
            exported[1].kill()
    for name, (r, rep) in parts:
        runs += r
        report[name] = rep
    return runs, report


# ------------------------------------------------------------------ phase 18

# the backbone paths of phase 18: fp32 (B.1, B.1b), bf16 with the block
# kernels (B.2, B.4, B.4b, B.5), GroupNorm (B.3)
DP_PATHS = ((), ("--mixed_precision", "--use_pallas_resblock", "--use_pallas_flash"), ("--use_pallas_groupnorm",))
DP_STEPS = 5                   # steps of each phase-18 run: step times are medians of steps 2-5
DP_GATE_STEP = 4               # ... and the parameters are compared after step 4
DP_LAYOUT_LR = 0.01            # the layout check's lr: each step moves the weights far past bf16's spacing


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class RankPair:
    """Two ranks on the one card (spawned processes over gloo: NCCL refuses
    two ranks on one device), started once before phase 14: each takes some
    13 s to import the port and reach the card, which they spend beside
    phases 14-17. Phases 18, 19 and 20 each hand them one job at their
    start (``submit``): a module-level ``target(rank, out)`` that makes its
    own process group, runs its steps and writes ``out/rank{r}.pt``; the
    phase runs its world of one and its one-process steps meanwhile, then
    waits (the handle ``submit`` returns: each rank's results and the job's
    seconds). Every launch counter is a process's own."""

    def __init__(self):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.jobs = [ctx.Queue() for _ in range(2)]
        self.done = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_loop, args=(r, self.jobs[r], self.done)) for r in range(2)]
        for p in self.procs:
            p.start()

    def submit(self, target, out, timeout):
        import queue

        for q in self.jobs:
            q.put((target.__name__, out))
        t0 = time.perf_counter()

        def wait():
            left = 2
            while left and time.perf_counter() < t0 + timeout and all(p.is_alive() for p in self.procs):
                try:
                    self.done.get(timeout=1.0)
                    left -= 1
                except queue.Empty:
                    pass
            secs = time.perf_counter() - t0
            if left:  # a rank failed to finish: neither takes another job
                self.close()
            return [torch.load(f, weights_only=False) if os.path.exists(f := os.path.join(out, f"rank{r}.pt"))
                    else {"error": f"no result after {secs:.0f} s"} for r in range(2)], secs
        return wait

    def close(self):
        for q, p in zip(self.jobs, self.procs):
            if p.is_alive():
                q.put(None)
        for p in self.procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join()


def _rank_loop(rank, jobs, done):
    """A rank of ``RankPair``: reach the card and import the port, then run
    each job it is handed, the torch.backends settings as it started."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.zeros(1, device="cuda")
    import tedm_tpu_torch.eval.run_tests  # noqa: F401
    import tedm_tpu_torch.train  # noqa: F401

    flags = lambda: (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                     torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    start = flags()
    while (job := jobs.get()) is not None:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = start
        globals()[job[0]](rank, job[1])
        done.put(rank)


def dp_run(tmp, flags, mode, label, steps=DP_STEPS, gate_step=DP_GATE_STEP):
    """One backbone run of phase 18: ``steps`` steps at batch 16 through
    train.main, without a process group (``mode`` None) or in a world of one
    under ``--multihost`` (``replicated``: DDP; ``fsdp``: FSDP2). Returns the
    losses, the parameters after step ``gate_step``, the launches a step and
    the median step ms of steps 2 on."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.train import main as train_main
    from tedm_tpu_torch.utils.checkpoint import load_checkpoint

    argv = ["--experiment", "img_only", "--synthetic_data", "--max_steps", str(steps), "--log_freq", "1",
            "--val_freq", str(10 * steps), "--ckpt_every", str(gate_step), "--seed", str(SEED),
            "--log_dir", os.path.join(tmp, "dp", label.replace(" ", "_")), *flags]
    if mode is not None:
        argv += ["--multihost", "--param_sharding", mode]
    cfg = config_from_args(argv)
    reset_launches()
    train_main(argv, device="cuda")
    torch.cuda.synchronize()
    counts = read_launches()
    recs = [r for r in read_metrics(cfg.log_dir) if "train/loss" in r]
    state, _ = load_checkpoint(os.path.join(cfg.log_dir, f"step_{gate_step}"), verbose=False)
    step_ms = [1e3 * cfg.batch_size / r["train/imgs_per_sec"] for r in recs]
    return {"losses": [r["train/loss"] for r in recs], "params": state["params"],
            "per_step": {k: v / steps for k, v in counts.items()}, "counts": counts,
            "step_ms": statistics.median(step_ms[1:]), "all_step_ms": step_ms}


def layout_check(tmp, flags, fresh: bool):
    """FSDP in a world of one on ``flags``' path at lr DP_LAYOUT_LR: in every
    training forward, each fused ResnetBlock's and PreNorm block's output
    (its weights laid out by ``kernels/layouts.py``) against its plain
    version on the weights it holds then, and each of its cached layouts
    against the layout built anew from those weights (equal unless stale).
    ``fresh`` False takes out the layout epochs (``layouts.new_epoch`` a
    no-op): the control. Returns the largest output error relative to the
    plain output's largest entry, by step (a NaN reads as inf); the count of
    stale layouts; how often a watched weight came back at the address of
    its freed storage; and how often it came back as the same tensor at the
    same address and version after an optimizer step, where a cache keyed by
    (tensor, version, address) alone would serve a stale layout."""
    from torch.optim.optimizer import register_optimizer_step_post_hook

    from tedm_tpu_torch.kernels import attn_block, layouts, resblock
    from tedm_tpu_torch.models.unet import LinearAttention, PreNormAttn, ResnetBlock
    from tedm_tpu_torch.parallel import mesh
    from tedm_tpu_torch.train import main as train_main

    errs, addresses, reused, keys, hazards, stale = collections.defaultdict(float), {}, [0], {}, [0], [0]
    step = [0]

    def stale_layouts(module) -> int:
        ids = {id(w): w for w in module.parameters()}
        n = 0
        for (wid, key), (ref, _, layout) in list(layouts._cache.items()):
            w = ids.get(wid)
            if w is None or ref() is not w:
                continue
            if isinstance(key, torch.dtype):  # B.4's tensor-core layout in that dtype
                now = resblock.tc_weight_layout(w, key)
            else:  # B.2's fragments of a (16 m-tiles, 16 k-tiles) view
                now = attn_block.fragment_layout(w.reshape(layout.shape[0] * 16, layout.shape[1] * 16))
            n += not torch.equal(now, layout)
        return n

    def hook(module, args, out):
        if not torch.is_grad_enabled():
            return
        with torch.no_grad():
            if isinstance(module, ResnetBlock):
                w, switch = module.block1.proj.weight, (module, "fused")
            else:
                w, switch = module.fn.fn.to_qkv.weight, (module.fn.fn, "use_pallas")
            setattr(*switch, False)
            ref = module.forward(*args)
            setattr(*switch, True)
            stale[0] += stale_layouts(module)
        ptr, key = w.data_ptr(), (id(w), w.data_ptr(), w._version)
        reused[0] += addresses.get(id(module)) == ptr
        hazards[0] += keys.get(id(module), (None, None))[1] == key and keys[id(module)][0] < step[0]
        addresses[id(module)], keys[id(module)] = ptr, (step[0], key)
        err = rel_err(out.float(), ref.float())
        errs[step[0]] = max(errs[step[0]], err if math.isfinite(err) else math.inf)

    wrap = mesh.DataParallel.wrap

    def wrap_and_watch(self, module, find_unused=False):
        out = wrap(self, module, find_unused)
        for m in module.modules():
            if (isinstance(m, ResnetBlock) and m.fused) or (
                    isinstance(m, PreNormAttn) and isinstance(m.fn.fn, LinearAttention) and m.compute_dtype == torch.bfloat16):
                m.register_forward_hook(hook, prepend=True)
        return out

    count_steps = lambda opt, *a, **k: step.__setitem__(0, step[0] + 1)
    handle = register_optimizer_step_post_hook(count_steps)
    new_epoch = layouts.new_epoch
    try:
        mesh.DataParallel.wrap = wrap_and_watch
        if not fresh:
            layouts.new_epoch = lambda: None
        train_main(["--experiment", "img_only", "--synthetic_data", "--max_steps", str(DP_STEPS), "--log_freq", "1",
                    "--val_freq", str(10 * DP_STEPS), "--seed", str(SEED), "--lr", str(DP_LAYOUT_LR),
                    "--log_dir", os.path.join(tmp, "dp", f"layouts_{fresh}"), "--multihost", "--param_sharding", "fsdp",
                    *flags], device="cuda")
    finally:
        mesh.DataParallel.wrap = wrap
        layouts.new_epoch = new_epoch
        handle.remove()
    return [errs[s] for s in sorted(errs)], stale[0], reused[0], hazards[0]


def dp_eval(tmp, base_dir, root):
    """run_tests in a world of one over phase 14's baseline checkpoint (a
    copy, with --multihost): its npz files against phase 14's."""
    import shutil

    from tedm_tpu_torch.eval import harness as H
    from tedm_tpu_torch.eval import run_tests

    mine = os.path.join(tmp, "dp", "eval")
    shutil.copytree(base_dir, mine)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        run_tests.main(["--experiment", mine, "--nih_path", os.path.join(root, "NIH"),
                        "--mon_path", os.path.join(root, "Montgomery"), "--multihost", "--rerun"], device="cuda")
    secs = time.perf_counter() - t0
    errs = {}
    for key in H.DATASET_KEYS:
        one, dp = (H.load_output(os.path.join(d, f"{key}_predictions.npz")) for d in (base_dir, mine))
        errs[key] = float(np.abs(one["y_hat"] - dp["y_hat"]).max())
    return errs, secs


DP_TWO_ROWS = 8  # rows a rank in the 2-rank check on one card: a global batch of phase 18's 16


def two_rank_inputs(out):
    """The 2-rank check's one step: the backbone's initial weights (from the
    seed, default widths) and a global batch of 2 * DP_TWO_ROWS synthetic
    images with its t and noise, made on the host from the seed and written
    to ``out``; rank r takes rows r * DP_TWO_ROWS on."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
    from tedm_tpu_torch.trainers import diffusion as D
    from tedm_tpu_torch.trainers.common import init_seeded, to_nchw

    cfg = config_from_args(["--experiment", "img_only", "--seed", str(SEED), "--log_dir", os.path.join(out, "unused")])
    n = 2 * DP_TWO_ROWS
    data = SyntheticCXRDataset("cxr_train", n, cfg.img_size, labelled=False, seed=SEED)
    rs = np.random.RandomState(SEED + 18)
    batch = {"init": init_seeded(SEED, lambda: D.build_model(cfg)).state_dict(),
             "x": to_nchw(np.stack([data[i] for i in range(n)]), "cpu"), "valid": torch.ones(n),
             "t": torch.from_numpy(rs.randint(0, cfg.timesteps, n)),
             "noise": torch.from_numpy(rs.standard_normal((n, 1, cfg.img_size, cfg.img_size)).astype(np.float32))}
    torch.save(batch, os.path.join(out, "batch.pt"))
    return batch


def backbone_step(batch, rows, dp=None):
    """One backbone step on the card from ``batch``'s weights over ``rows``
    of it, with its t and noise: the loss, the gradients the optimizer used
    (under DDP the mean over the ranks) and the parameters after the step."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers import diffusion as D
    from tedm_tpu_torch.trainers.common import make_optimizer

    cfg = config_from_args(["--experiment", "img_only", "--seed", str(SEED), "--log_dir", tempfile.gettempdir()])
    unet = D.build_model(cfg)
    unet.load_state_dict(batch["init"])
    unet.to("cuda")
    model = unet if dp is None else dp.wrap(unet)
    params = unet.parameters() if dp is None else dp.optimizer_params(unet.parameters())
    sched = make_schedule(cfg.timesteps, cfg.beta_schedule, cfg.p2_loss_weight_gamma, cfg.p2_loss_weight_k).to("cuda")
    steps = D.make_steps(cfg, model, sched, make_optimizer(cfg, params), None, dp)
    pick = lambda k: batch[k][rows].cuda()
    loss, _ = steps.train_step(pick("x"), torch.zeros(1, device="cuda"), pick("valid"), t=pick("t"), noise=pick("noise"))
    return {"loss": loss.item(), "lr": cfg.lr, "grads": {n: p.grad.cpu() for n, p in unet.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in unet.named_parameters()}}


def two_ranks_on_one_card(tmp, pair):
    """DDP of 2 ranks on the one card over gloo (NCCL refuses two ranks on
    one device), handed to ``pair``. Each rank runs a backbone through
    train.main for 2 steps at batch DP_TWO_ROWS and keeps its logged losses
    and its parameters after step 2, then takes one DDP step on its rows of
    ``two_rank_inputs``' global batch. Returns a function that takes this
    process's step on the whole batch, waits for the ranks and returns each
    rank's results (or the error that stopped it), the one-process step and
    the job's seconds."""
    out = os.path.join(tmp, "dp", "two")
    os.makedirs(out, exist_ok=True)
    batch = two_rank_inputs(out)
    wait = pair.submit(_gloo_rank, out, 300)

    def finish():
        one = backbone_step(batch, slice(None))
        ranks, secs = wait()
        return ranks, one, secs
    return finish


def _gloo_rank(rank, out):
    import datetime
    import traceback

    import torch.distributed as dist
    from torch.optim.optimizer import register_optimizer_step_post_hook

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    res = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), 2), rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=120))
        torch.cuda.set_device(0)
        from tedm_tpu_torch.parallel.mesh import DataParallel
        from tedm_tpu_torch.train import main as train_main
        from tedm_tpu_torch.utils import logging

        log = logging.MetricsLogger.log
        losses, params = [], []

        def recording(self, metrics, step):
            if "train/loss" in metrics:
                losses.append(float(metrics["train/loss"]))
            return log(self, metrics, step)

        def keep_params(optimizer, *_):
            params[:] = [p.detach().cpu().clone() for g in optimizer.param_groups for p in g["params"]]

        logging.MetricsLogger.log = recording
        handle = register_optimizer_step_post_hook(keep_params)
        train_main(["--experiment", "img_only", "--synthetic_data", "--max_steps", "2", "--log_freq", "1",
                    "--val_freq", "100", "--batch_size", str(DP_TWO_ROWS), "--seed", str(SEED), "--multihost",
                    "--log_dir", os.path.join(out, f"r{rank}", "run")], device="cuda:0")
        handle.remove()
        logging.MetricsLogger.log = log
        batch = torch.load(os.path.join(out, "batch.pt"), weights_only=False)
        step = backbone_step(batch, slice(rank * DP_TWO_ROWS, (rank + 1) * DP_TWO_ROWS), DataParallel("replicated"))
        res = {"losses": losses, "params_after_2": params, "step": step}
        dist.destroy_process_group()
    except Exception:
        res = {"error": traceback.format_exc()[-1500:]}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def adam_param_err(got, want, grads, lr):
    """The largest difference of parameters after one Adam step in units of
    its bound, and the tensor where it lies. The bound is 1e-3 * lr where
    the gradient is more than 1e-4 of its tensor's largest entry and more
    than 1e-5, else 2 * lr, plus two fp32 spacings of the parameter. Adam's
    first step moves an entry by lr * g / (|g| + 1e-8): a gradient that
    rounding can flip moves it by up to lr either way, and near |g| = 1e-6
    a rounding error of 1e-7 in g (1e-5 of a largest gradient of 1e-2, as
    the card reads at full width) swings it by 1e-3 * lr; and the stored
    parameter is rounded to fp32, whose spacing at |p| = 1 (a GroupNorm
    gain) is 1.2e-7, more than 1e-3 * lr at lr 1e-4. At most 1 passes."""
    worst, where = 0.0, None
    for n, w in want.items():
        g = grads[n].abs()
        bound = torch.where((g > 1e-4 * g.max()) & (g > 1e-5), 1e-3 * lr, 2 * lr)
        bound = bound + 2 * torch.finfo(torch.float32).eps * w.abs()
        err = ((got[n] - w).abs() / bound).max().item()
        if err >= worst:
            worst, where = err, n
    return worst, where


def phase_18(tmp, base_dir, root, pair):
    """Phase 18: data parallel in a world of one under NCCL, against the same
    runs without a process group, while ``pair`` runs the 2-rank check.
    Returns the runs' launches by path, the measurements and the runs
    without a group (phase 19 holds TP to them too)."""
    import torch.distributed as dist

    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    # cuDNN's deterministic algorithms in all of this phase's runs, so that a
    # run in a world of one can be held to the run without a group
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs, report = [], {}
    try:
        finish_two = two_ranks_on_one_card(tmp, pair)
        # every run without a group first: --multihost's group lives on in the process
        plain = {flags: dp_run(tmp, flags, None, label_of("--mixed_precision" in flags, flags) + "plain")
                 for flags in DP_PATHS}
        for flags in DP_PATHS:
            mixed = "--mixed_precision" in flags
            kernel_flags = tuple(f for f in flags if f != "--mixed_precision")
            label = label_of(mixed, kernel_flags) + "backbone"
            loss_gate, param_gate = (BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL) if mixed else (STEP_LOSS_TOL, STEP_GRAD_TOL)
            one = plain[flags]
            if one["per_step"] != per_unet_call(mixed, kernel_flags, backward=True):
                fail(f"phase 18 {label}: {one['per_step']} launches a step without a group, expected "
                     f"{per_unet_call(mixed, kernel_flags, backward=True)}")
            row = {"plain_step_ms": one["step_ms"], "plain_all_step_ms": one["all_step_ms"]}
            for mode, name in (("replicated", "DDP"), ("fsdp", "FSDP")):
                got = dp_run(tmp, flags, mode, f"{label} {name}")
                loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], one["losses"]))
                param_err = max(((got["params"][k] - v).abs().max() / v.abs().max().clamp(min=1e-12)).item()
                                for k, v in one["params"].items())
                print(f"phase 18 {label} {name} (world of one, NCCL): losses {got['losses']} against "
                      f"{one['losses']} without a group (largest relative difference {loss_err:.3e}, gate "
                      f"{loss_gate}); parameters after step {DP_GATE_STEP}: largest difference {param_err:.3e} of a tensor's largest "
                      f"entry (gate {param_gate}); launches a step {({k: v for k, v in got['per_step'].items() if v})} "
                      f"(without a group {({k: v for k, v in one['per_step'].items() if v})}); median step "
                      f"{got['step_ms']:.3f} ms against {one['step_ms']:.3f} ms ({got['step_ms'] / one['step_ms']:.3f}x); "
                      f"step ms {[round(x, 2) for x in got['all_step_ms']]}", flush=True)
                if len(got["losses"]) != DP_STEPS or not loss_err <= loss_gate or not param_err <= param_gate:
                    fail(f"phase 18 {label} {name}: losses or parameters off the run without a group")
                if got["per_step"] != one["per_step"]:
                    fail(f"phase 18 {label} {name}: launches a step {got['per_step']} != {one['per_step']}")
                runs.append((f"{label_of(mixed, kernel_flags)}training (a) {name}", got["counts"]))
                row[name] = {"step_ms": got["step_ms"], "all_step_ms": got["all_step_ms"],
                             "vs_plain": got["step_ms"] / one["step_ms"], "loss_err": loss_err,
                             "param_err": param_err}
            report[label] = row
        # point f: B.2's and B.4's cached weight layouts under FSDP
        flags = DP_PATHS[1]
        errs, stale, reused, hazards = layout_check(tmp, flags, fresh=True)
        ctl, ctl_stale, ctl_reused, ctl_hazards = layout_check(tmp, flags, fresh=False)
        print(f"phase 18 FSDP layouts (bf16 resblock + flash, lr {DP_LAYOUT_LR}): largest error of a fused "
              f"ResnetBlock or PreNorm block against its plain version on the current weights, by step: "
              f"{[f'{e:.3e}' for e in errs]} (gate {BLOCK_TOL}); cached layouts unlike the ones built anew from "
              f"the current weights: {stale}; a watched weight at its freed storage's address {reused} times, the "
              f"same tensor, address and version after an optimizer step {hazards} times. Control without layout "
              f"epochs: {[f'{e:.3e}' for e in ctl]}, {ctl_stale} stale layouts ({ctl_reused} reuses, {ctl_hazards} "
              f"same keys)", flush=True)
        if len(errs) != DP_STEPS or not max(errs) <= BLOCK_TOL or stale:
            fail(f"phase 18: a stale weight layout under FSDP: errors {errs}, {stale} stale layouts")
        if ctl_hazards and not ctl_stale:
            fail("phase 18: the control served no stale layout where a weight came back unchanged in key")
        report["layouts"] = {"errors": errs, "stale": stale, "reused": reused, "same_key": hazards,
                             "control_errors": ctl, "control_stale": ctl_stale, "control_reused": ctl_reused,
                             "control_same_key": ctl_hazards}
        two, one, secs = finish_two()
        errors = [r["error"] for r in two if "error" in r]
        if errors:
            fail(f"phase 18: 2 ranks on one card: {errors}")
        losses = [r["losses"] for r in two]
        same_params = len(two[0]["params_after_2"]) == len(two[1]["params_after_2"]) > 0 and all(
            torch.equal(a, b) for a, b in zip(two[0]["params_after_2"], two[1]["params_after_2"]))
        steps = [r["step"] for r in two]
        loss_err = abs(steps[0]["loss"] - one["loss"]) / abs(one["loss"])
        grad_errs = {n: rel_err(steps[0]["grads"][n], g) for n, g in one["grads"].items()}
        worst = max(grad_errs, key=grad_errs.get)
        param_err, param_at = adam_param_err(steps[0]["params"], one["params"], one["grads"], one["lr"])
        step_same = steps[0]["loss"] == steps[1]["loss"] and all(
            torch.equal(steps[0]["params"][n], steps[1]["params"][n]) for n in one["params"])
        print(f"phase 18 DDP of 2 ranks on the one card over gloo (NCCL refuses two ranks on one device): "
              f"{secs:.1f} s from its hand-over, beside the runs above; train.main at batch {DP_TWO_ROWS} a rank: "
              f"each rank's logged losses {losses}, "
              f"parameters after step 2 bitwise equal on both ranks: {same_params}; one DDP step on rows of a "
              f"global batch of {2 * DP_TWO_ROWS} against one process on the whole batch, with the same t and "
              f"noise: loss {steps[0]['loss']:.6f} vs {one['loss']:.6f} (relative {loss_err:.2e}, tol "
              f"{STEP_LOSS_TOL}), gradients of {len(grad_errs)} tensors worst relative to the tensor's largest "
              f"entry {grad_errs[worst]:.2e} at {worst} (tol {STEP_GRAD_TOL}), parameters after the step "
              f"{param_err:.3f} of Adam's bound at {param_at} (at most 1); both ranks' loss and parameters equal: "
              f"{step_same}",
              flush=True)
        if not losses[0] or losses[0] != losses[1] or len(losses[0]) != 2 or not all(map(math.isfinite, losses[0])):
            fail(f"phase 18: 2 ranks on one card logged losses {losses}")
        if not same_params or not step_same:
            fail("phase 18: 2 ranks on one card hold different parameters")
        if not (math.isfinite(one["loss"]) and loss_err <= STEP_LOSS_TOL and grad_errs[worst] <= STEP_GRAD_TOL
                and param_err <= 1.0):
            fail("phase 18: the 2-rank DDP step on one card disagrees with one process on the global batch")
        report["two ranks on one card (gloo)"] = {"seconds": secs, "losses": losses[0], "step_loss_rel_err": loss_err,
                                                  "step_worst_grad_rel_err": grad_errs[worst],
                                                  "step_param_err_of_bound": param_err}
        errs, secs = dp_eval(tmp, base_dir, root)
        print(f"phase 18 run_tests --multihost in a world of one over phase 14's baseline: {secs:.2f} s; largest "
              f"difference of y_hat from phase 14's npz by set {errs} (gate {PATH_TOL})", flush=True)
        if not max(errs.values()) <= PATH_TOL:
            fail(f"phase 18: the eval in a world of one differs from phase 14's: {errs}")
        report["eval"] = {"seconds": secs, "max_abs_err": errs}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return runs, report, plain


# ------------------------------------------------------------------ phase 19

TP_AXES = ("--mesh_axes", "data", "model")
TP_ROWS = 4                    # the global batch of the 2-rank TP steps (both ranks take every row)
TP_WIDTH = 256                 # --tp_min_width of the 2-rank steps (JAX's default)
TP_TWO_PATHS = ((), ("--mixed_precision", "--use_pallas_resblock", "--use_pallas_flash"))
DEVICE_STEPS = 3               # backbone steps of the --data_backend device run


def tp_world_of_one(tmp, plain):
    """Phase 19 (a): TP in a world of one under NCCL (mesh (1, 1) over data
    and model): phase 18's backbone runs on each of its paths, against the
    same run without a group (``plain``, phase 18's). Returns the runs'
    launches by path and the measurements."""
    runs, report = [], {}
    for flags in DP_PATHS:
        mixed = "--mixed_precision" in flags
        kernel_flags = tuple(f for f in flags if f != "--mixed_precision")
        label = label_of(mixed, kernel_flags) + "backbone TP"
        loss_gate, param_gate = (BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL) if mixed else (STEP_LOSS_TOL, STEP_GRAD_TOL)
        one = plain[flags]
        got = dp_run(tmp, (*flags, "--mesh_shape", "1", "1", *TP_AXES), "tp", label)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], one["losses"]))
        param_err = max(((got["params"][k] - v).abs().max() / v.abs().max().clamp(min=1e-12)).item()
                        for k, v in one["params"].items())
        print(f"phase 19 {label} (mesh 1 x 1, world of one, NCCL): losses {got['losses']} against "
              f"{one['losses']} without a group (largest relative difference {loss_err:.3e}, gate {loss_gate}); "
              f"parameters after step {DP_GATE_STEP}: largest difference {param_err:.3e} of a tensor's largest "
              f"entry (gate {param_gate}); launches a step {({k: v for k, v in got['per_step'].items() if v})}; "
              f"median step {got['step_ms']:.3f} ms against {one['step_ms']:.3f} ms "
              f"({got['step_ms'] / one['step_ms']:.3f}x)", flush=True)
        if len(got["losses"]) != DP_STEPS or not loss_err <= loss_gate or not param_err <= param_gate:
            fail(f"phase 19 {label}: losses or parameters off the run without a group")
        if got["per_step"] != one["per_step"]:
            fail(f"phase 19 {label}: launches a step {got['per_step']} != {one['per_step']}")
        runs.append((f"{label_of(mixed, kernel_flags)}training (a) TP 1x1", got["counts"]))
        report[label] = {"step_ms": got["step_ms"], "plain_step_ms": one["step_ms"], "loss_err": loss_err,
                         "param_err": param_err, "all_step_ms": got["all_step_ms"]}
    return runs, report


def tp_config(*flags):
    """The backbone's config (default widths) with ``flags``."""
    from tedm_tpu_torch.config import config_from_args

    return config_from_args(["--experiment", "img_only", "--seed", str(SEED), "--log_dir", tempfile.gettempdir(),
                             *flags])


def unsharded_backbone(flags):
    """A backbone of ``flags`` on the CPU, not sharded (the rule's shapes)."""
    from tedm_tpu_torch.trainers import diffusion as D

    return D.build_model(tp_config(*flags))


def tedm_head(cfg):
    from tedm_tpu_torch.models.segmentation import PixelClassifier

    return PixelClassifier(stage_channels=tuple(cfg.dim * m for m in reversed(cfg.dim_mults)), img_size=cfg.img_size,
                           shared=True)


def tp_inputs(out):
    """The 2-rank TP check's inputs, made on the host from the seed: the
    backbone's initial weights (default widths), TP_ROWS synthetic images
    with their t and noise; a TEDM head's weights, one labelled image and
    its feature noise (its 8 timesteps)."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
    from tedm_tpu_torch.trainers.common import init_seeded, to_nchw

    cfg = tp_config()
    t_steps = config_from_args(["--experiment", "TEDM", "--log_dir", tempfile.gettempdir()]).t_steps_to_save
    data = SyntheticCXRDataset("cxr_train", TP_ROWS, cfg.img_size, labelled=False, seed=SEED)
    img, mask = SyntheticCXRDataset("train", 1, cfg.img_size, labelled=True, seed=SEED)[0]
    rs = np.random.RandomState(SEED + 19)
    s = len(t_steps)
    clf = init_seeded(SEED + 1, lambda: tedm_head(cfg))
    batch = {"init": init_seeded(SEED, lambda: unsharded_backbone(())).state_dict(),
             "x": to_nchw(np.stack([data[i] for i in range(TP_ROWS)]), "cpu"), "valid": torch.ones(TP_ROWS),
             "t": torch.from_numpy(rs.randint(0, cfg.timesteps, TP_ROWS)),
             "noise": torch.from_numpy(rs.standard_normal((TP_ROWS, 1, cfg.img_size, cfg.img_size)).astype(np.float32)),
             "classifier": clf.state_dict(), "t_steps": tuple(t_steps),
             "img": to_nchw(img[None], "cpu"), "mask": to_nchw(mask[None], "cpu"),
             "feature_noise": torch.from_numpy(rs.standard_normal((s, 1, cfg.img_size, cfg.img_size)).astype(np.float32))}
    torch.save(batch, os.path.join(out, "batch.pt"))
    return batch


def tp_full(module) -> dict:
    """The full gradients and parameters of ``module``, a TP rank's gathered."""
    from tedm_tpu_torch.parallel import tensor_parallel as tp

    whole = lambda p, t: tp.all_gather(t, p.tp, 0) if tp.is_sharded(p) else t
    return {"grads": {n: whole(p, p.grad).cpu() for n, p in module.named_parameters() if p.grad is not None},
            "params": {n: whole(p, p.detach()).cpu() for n, p in module.named_parameters()},
            "replicated": {n: p.detach().cpu() for n, p in module.named_parameters() if not tp.is_sharded(p)}}


def tp_backbone_step(batch, flags, dp=None):
    """One backbone step on the card from ``batch``'s weights over its rows,
    with its t and noise, in one process or on a TP rank (``dp``)."""
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers import diffusion as D
    from tedm_tpu_torch.trainers.common import make_optimizer

    cfg = tp_config(*flags)
    unet = D.build_model(cfg)
    unet.load_state_dict(batch["init"])
    unet.to("cuda")
    model = unet if dp is None else dp.wrap(unet)
    sched = make_schedule(cfg.timesteps, cfg.beta_schedule, cfg.p2_loss_weight_gamma, cfg.p2_loss_weight_k).to("cuda")
    steps = D.make_steps(cfg, model, sched, make_optimizer(cfg, unet.parameters()), None, dp)
    pick = lambda k: batch[k].cuda()
    loss, _ = steps.train_step(pick("x"), torch.zeros(1, device="cuda"), pick("valid"), t=pick("t"), noise=pick("noise"))
    return {"loss": loss.item(), **tp_full(unet), "module": unet}


def tp_head_step(batch, dp=None):
    """One TEDM head step (fp32, the backbone under --use_pallas_groupnorm)
    on the card from ``batch``'s weights, image and feature noise."""
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.trainers.common import make_train_step
    from tedm_tpu_torch.trainers.datasetdm import SegTask

    unet = unsharded_backbone(("--use_pallas_groupnorm",))
    unet.load_state_dict(batch["init"])
    unet = unet.to("cuda").eval().requires_grad_(False)
    clf = tedm_head(tp_config())
    clf.load_state_dict(batch["classifier"])
    clf.to("cuda")
    if dp is not None:
        dp.place(unet)
    task = SegTask(unet=unet, classifier=clf if dp is None else dp.wrap(clf, find_unused=True),
                   sched=make_schedule(1000, "cosine").to("cuda"), t_steps=batch["t_steps"], normalize=True,
                   fold=len(batch["t_steps"]))
    step = make_train_step(task, torch.optim.Adam(clf.parameters(), lr=1e-4), (), dp)
    loss, _ = step(batch["img"].cuda(), batch["mask"].cuda(), torch.ones(1, device="cuda"),
                   noise=batch["feature_noise"].cuda())
    return {"loss": loss.item(), **tp_full(clf), "backbone": unet}


def _tp_gloo_rank(rank, out):
    """A rank of phase 19 (b): TP over a (1, 2) mesh on the card over gloo."""
    import datetime
    import traceback

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    res = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), 2), rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=300))
        torch.cuda.set_device(0)
        from tedm_tpu_torch.parallel import mesh
        from tedm_tpu_torch.parallel import tensor_parallel as tp

        mesh.make_mesh((1, 2), ("data", "model"))
        batch = torch.load(os.path.join(out, "batch.pt"), weights_only=False)
        t0 = time.perf_counter()
        for flags in TP_TWO_PATHS:
            reset_launches()
            step = tp_backbone_step(batch, flags, mesh.DataParallel("tp", tp_min_width=TP_WIDTH))
            torch.cuda.synchronize()
            unet = step.pop("module")
            plan = tp.plan_of(unsharded_backbone(flags), 2, TP_WIDTH)
            res[flags] = {**step, "counts": read_launches(), "bytes": param_bytes(unet, plan)}
        reset_launches()
        head = tp_head_step(batch, mesh.DataParallel("tp", tp_min_width=TP_WIDTH))
        torch.cuda.synchronize()
        bb = head.pop("backbone")
        res["TEDM"] = {**head, "counts": read_launches(),
                       "bytes": param_bytes(bb, tp.plan_of(unsharded_backbone(("--use_pallas_groupnorm",)), 2, TP_WIDTH))}
        res["seconds"] = time.perf_counter() - t0
        dist.destroy_process_group()
    except Exception:
        res = {"error": traceback.format_exc()[-2000:]}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def param_bytes(module, plan) -> dict:
    """A TP rank's parameter bytes, the rule's count of them (each parameter
    that ``plan`` shards at half its full bytes) and the full bytes."""
    from tedm_tpu_torch.parallel import tensor_parallel as tp

    held = {n: p.numel() * p.element_size() for n, p in module.named_parameters()}
    full = {n: b * (2 if tp.is_sharded(p) else 1) for (n, b), p in zip(held.items(), module.parameters())}
    return {"held": sum(held.values()), "rule": sum(b // 2 if plan[n] else b for n, b in full.items()),
            "full": sum(full.values()), "sharded": sum(plan.values())}


def tp_two_ranks(tmp, pair):
    """Phase 19 (b): TP of 2 ranks on the one card over gloo, mesh (1, 2) at
    --tp_min_width TP_WIDTH, handed to ``pair``: a backbone step in fp32 and
    in bf16 with resblock + flash, and a TEDM head step with groupnorm, each
    against one process on the same batch. Returns a function that takes
    the one-process steps, waits for the ranks and returns the runs'
    launches and the measurements."""
    out = os.path.join(tmp, "tp", "two")
    os.makedirs(out, exist_ok=True)
    batch = tp_inputs(out)
    wait = pair.submit(_tp_gloo_rank, out, 600)
    return lambda: tp_two_ranks_against_one(batch, wait)


def tp_two_ranks_against_one(batch, wait):
    """Phase 19 (b)'s one-process steps, then the ranks' (``wait``) against
    them."""
    cases = [(flags, label_of("--mixed_precision" in flags, tuple(f for f in flags if f != "--mixed_precision"))
              + "backbone step", lambda flags=flags: tp_backbone_step(batch, flags)) for flags in TP_TWO_PATHS]
    cases.append(("TEDM", "--use_pallas_groupnorm TEDM head step", lambda: tp_head_step(batch)))
    ones = []
    for key, label, one_step in cases:
        one = one_step()
        one.pop("module", None)
        one.pop("backbone", None)
        ones.append((key, label, one))
    ranks, secs = wait()
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        fail(f"phase 19: TP on 2 ranks: {errors}")
    runs, report = [], {"seconds": secs, "rank_seconds": ranks[0]["seconds"]}
    for key, label, one in ones:
        mixed = "--mixed_precision" in key
        loss_tol, grad_tol = (BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL) if mixed else (STEP_LOSS_TOL, STEP_GRAD_TOL)
        r0, r1 = ranks[0][key], ranks[1][key]
        loss_err = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
        grad_errs = {n: rel_err(r0["grads"][n], g) for n, g in one["grads"].items()}
        worst = max(grad_errs, key=grad_errs.get)
        same = r0["loss"] == r1["loss"] and r0["replicated"].keys() == r1["replicated"].keys() and all(
            torch.equal(v, r1["replicated"][n]) for n, v in r0["replicated"].items())
        b = r0["bytes"]
        print(f"phase 19 TP of 2 ranks on the one card over gloo, mesh 1 x 2, --tp_min_width {TP_WIDTH}, {label} "
              f"at batch {TP_ROWS if key != 'TEDM' else 1} against one process on the same batch: loss "
              f"{r0['loss']:.6f} vs {one['loss']:.6f} (relative {loss_err:.2e}, tol {loss_tol}); gradients of "
              f"{len(grad_errs)} tensors, worst relative to the tensor's largest entry {grad_errs[worst]:.2e} at "
              f"{worst} (tol {grad_tol}); both ranks' loss and {len(r0['replicated'])} replicated parameters "
              f"equal: {same}; a rank's parameter bytes {b['held']} (the rule's count {b['rule']}, of "
              f"{b['full']}, {b['sharded']} tensors sharded); launches on rank 0 "
              f"{({k: v for k, v in r0['counts'].items() if v})}", flush=True)
        if not (math.isfinite(one["loss"]) and loss_err <= loss_tol and grad_errs[worst] <= grad_tol):
            fail(f"phase 19: the 2-rank TP {label} disagrees with one process")
        if not same:
            fail(f"phase 19: the 2-rank TP {label}: the ranks hold different replicated parameters")
        if b["held"] != b["rule"] or not b["held"] < b["full"]:
            fail(f"phase 19: the 2-rank TP {label}: a rank holds {b['held']} parameter bytes, the rule {b['rule']}")
        runs.append((f"{label.replace(' step', '')} TP 1x2 (gloo)", r0["counts"]))
        report[label] = {"loss_rel_err": loss_err, "worst_grad_rel_err": grad_errs[worst], "param_bytes": b,
                         "launches": {k: v for k, v in r0["counts"].items() if v}}
    print(f"phase 19 TP of 2 ranks over gloo: {secs:.1f} s from its hand-over (beside the world of one), "
          f"{ranks[0]['seconds']:.1f} s in rank 0's steps "
          "(gloo copies each gathered tensor through the host: not a cost of TP on NCCL)", flush=True)
    return runs, report


def device_backend(tmp):
    """Phase 19 (c): --data_backend device: backbone steps through
    train.main whose batches are rendered on the card, and the same indices
    in two batches of different composition rendering the same pixels."""
    from tedm_tpu_torch.data import device_synthetic as ds
    from tedm_tpu_torch.train import main as train_main
    from tedm_tpu_torch.trainers import diffusion as D

    seen = []
    to_nchw = D.to_nchw

    def watched(a, device):
        if a.shape[0] == cfg.batch_size:  # an image batch (not the dummy condition)
            seen.append(torch.is_tensor(a) and a.is_cuda)
        return to_nchw(a, device)

    argv = ["--experiment", "img_only", "--synthetic_data", "--data_backend", "device", "--max_steps",
            str(DEVICE_STEPS), "--log_freq", "1", "--val_freq", "100", "--seed", str(SEED),
            "--log_dir", os.path.join(tmp, "tp", "device")]
    from tedm_tpu_torch.config import config_from_args

    cfg = config_from_args(argv)
    D.to_nchw = watched
    try:
        t0 = time.perf_counter()
        train_main(argv, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        D.to_nchw = to_nchw
    losses = [r["train/loss"] for r in read_metrics(cfg.log_dir) if "train/loss" in r]
    base = ds.base_seed("cxr_train", SEED)
    a = ds.render(ds.draws(base, np.array([3, 5, 7, 9]), cfg.img_size, "cuda"), False)[0]
    b = ds.render(ds.draws(base, np.array([9, 1, 3]), cfg.img_size, "cuda"), False)[0]
    pure = torch.equal(a[0], b[2]) and torch.equal(a[3], b[0])
    print(f"phase 19 --data_backend device: {DEVICE_STEPS} backbone steps through train.main in {secs:.1f} s, "
          f"losses {losses}; image batches on the card before each step: {sum(seen)} of {len(seen)}; indices 3 "
          f"and 9 render the same pixels in batches [3, 5, 7, 9] and [9, 1, 3]: {pure}", flush=True)
    if len(losses) != DEVICE_STEPS or not all(map(math.isfinite, losses)) or not seen or not all(seen) or not pure:
        fail("phase 19: --data_backend device")
    return {"seconds": secs, "losses": losses, "on_card": f"{sum(seen)} of {len(seen)}", "pure": pure}


def grain_backend(tmp):
    """Phase 19 (d): --data_backend grain trains where grain imports, and
    refuses before any step, naming the package, where it does not."""
    import importlib.util

    from tedm_tpu_torch.train import main as train_main

    argv = ["--experiment", "img_only", "--synthetic_data", "--data_backend", "grain", "--max_steps", "2",
            "--log_freq", "1", "--val_freq", "100", "--seed", str(SEED), "--log_dir", os.path.join(tmp, "tp", "grain")]
    if importlib.util.find_spec("grain") is not None:
        train_main(argv, device="cuda")
        print("phase 19 --data_backend grain: grain imports here; 2 backbone steps ran", flush=True)
        return {"grain": "ran 2 steps"}
    try:
        train_main(argv, device="cuda")
    except ModuleNotFoundError as e:
        if "grain" not in str(e):
            fail(f"phase 19: --data_backend grain refused without naming grain: {e}")
        print(f"phase 19 --data_backend grain: grain is not installed here; train.main refused before any step: {e}",
              flush=True)
        return {"grain": f"refused: {e}"}
    fail("phase 19: --data_backend grain ran without the grain package")


def phase_19(tmp, pair, plain):
    """Phase 19: the model mesh axis and the input backends; ``pair`` runs
    the 2-rank steps beside the world of one, which is held to phase 18's
    runs without a group (``plain``)."""
    import torch.distributed as dist

    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    finish_two = tp_two_ranks(tmp, pair)
    try:
        runs, report = tp_world_of_one(tmp, plain)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    runs2, report["two ranks (gloo)"] = finish_two()
    report["device backend"] = device_backend(tmp)
    report["grain backend"] = grain_backend(tmp)
    return runs + runs2, report


# ------------------------------------------------------------------ phase 20

SP_AXES = ("--mesh_axes", "data", "spatial", "--shard_spatial")
SP_PATHS = ((), ("--mixed_precision",), ("--use_pallas_groupnorm", "--use_pallas_resblock", "--use_pallas_flash"))
SP_STEPS = 3                   # path (a) steps of each phase-20 (a) run; the parameters are compared after the last
SP_TWO_PATHS = ((), ("--mixed_precision", "--use_pallas_resblock", "--use_pallas_flash"))
SP_CL = ("global_cl", "local_cl")
SP_TWO_KEYS = (*SP_TWO_PATHS, "TEDM", *SP_CL, "finetune")  # phase 20 (b) and (c)'s steps on 2 ranks
SP_CL_ROWS = 2                 # images of a phase-20 (c) step (a CL step's 4 views)
SP_EVAL_ROWS = 2               # images of each set in phase 20 (d), one batch
SP_METRIC_TOL = 1e-6           # phase 20 (d): each image's Dice, precision and recall


def sp_world_of_one(tmp):
    """Phase 20 (a): --shard_spatial on a (1, 1) data x spatial mesh in a
    world of one under NCCL, path (a) at batch 16 in fp32, bf16, and fp32
    with groupnorm + resblock + flash, each against the run without a group:
    losses and parameters bit for bit, launches a step equal. Returns the
    runs' launches by path and the measurements."""
    runs, report = [], {}
    for flags in SP_PATHS:
        mixed = "--mixed_precision" in flags
        kernel_flags = tuple(f for f in flags if f != "--mixed_precision")
        label = label_of(mixed, kernel_flags) + "backbone SP"
        one = dp_run(tmp, flags, None, label + " plain", SP_STEPS, SP_STEPS)
        got = dp_run(tmp, (*flags, "--mesh_shape", "1", "1", *SP_AXES), "replicated", label, SP_STEPS, SP_STEPS)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], one["losses"]))
        param_err = max(((got["params"][k] - v).abs().max() / v.abs().max().clamp(min=1e-12)).item()
                        for k, v in one["params"].items())
        print(f"phase 20 {label} (mesh 1 x 1 over data and spatial, world of one, NCCL): losses {got['losses']} "
              f"against {one['losses']} without a group (largest relative difference {loss_err:.3e}, gate 0); "
              f"parameters after step {SP_STEPS}: largest difference {param_err:.3e} of a tensor's largest entry "
              f"(gate 0); launches a step {({k: v for k, v in got['per_step'].items() if v})} (without a group "
              f"{({k: v for k, v in one['per_step'].items() if v})}); median step {got['step_ms']:.3f} ms against "
              f"{one['step_ms']:.3f} ms", flush=True)
        if len(got["losses"]) != SP_STEPS or loss_err != 0.0 or param_err != 0.0:
            fail(f"phase 20 {label}: losses or parameters not bit for bit those of the run without a group")
        if got["per_step"] != one["per_step"] or one["per_step"] != per_unet_call(mixed, kernel_flags, backward=True):
            fail(f"phase 20 {label}: launches a step {got['per_step']}, without a group {one['per_step']}")
        runs.append((f"{label_of(mixed, kernel_flags)}training (a) SP 1x1", got["counts"]))
        report[label] = {"step_ms": got["step_ms"], "plain_step_ms": one["step_ms"], "loss_err": loss_err,
                         "param_err": param_err, "launches_per_step": {k: v for k, v in got["per_step"].items() if v}}
    return runs, report


def _sp_gloo_rank(rank, out):
    """A rank of phase 20 (b): --shard_spatial over a (1, 2) data x spatial
    mesh on the card over gloo: each rank holds 64 of the 128 rows."""
    import datetime
    import traceback

    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    res = {}
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), 2), rank=rank,
                                world_size=2, timeout=datetime.timedelta(seconds=300))
        torch.cuda.set_device(0)
        from tedm_tpu_torch.parallel import mesh

        mesh.make_mesh((1, 2), ("data", "spatial"))
        batch = torch.load(os.path.join(out, "batch.pt"), weights_only=False)
        t0 = time.perf_counter()
        for key in SP_TWO_KEYS:
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            step = sp_step(key, batch, mesh.DataParallel("replicated", shard_spatial=True))
            torch.cuda.synchronize()
            res[key] = {**step, "counts": read_launches(), "peak_bytes": torch.cuda.max_memory_allocated()}
        res["seconds"] = time.perf_counter() - t0
        res["eval"] = sp_rank_eval(batch["eval_dir"])
        dist.destroy_process_group()
    except Exception:
        res = {"error": traceback.format_exc()[-2000:]}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def sp_two_ranks(tmp, pair):
    """Phase 20 (b)-(d): --shard_spatial on 2 ranks on the one card over
    gloo, mesh (1, 2): a backbone step in fp32 and in bf16 resblock + flash
    (batch 4, 128^2), a TEDM head step with groupnorm (batch 1), and (c)
    the CL steps (``sp_cl_step``), each against one process on the same
    batch at phase 6's and 10's gates; the kernels each rank launched
    against one process's; each rank's peak memory against one process's
    (a record); then (d), run_tests on the ranks against one process.
    The ranks' job goes to ``pair``; returns a function that takes the
    one-process steps and eval, waits for the ranks and returns the runs'
    launches and the measurements."""
    out = os.path.join(tmp, "sp", "two")
    os.makedirs(out, exist_ok=True)
    sp_dir, one_dir = sp_eval_dirs(out)
    batch = {**tp_inputs(out), **sp_cl_inputs(), "eval_dir": sp_dir}
    torch.save(batch, os.path.join(out, "batch.pt"))
    wait = pair.submit(_sp_gloo_rank, out, 600)
    return lambda: sp_two_ranks_against_one(batch, wait, sp_dir, one_dir)


def sp_two_ranks_against_one(batch, wait, sp_dir, one_dir):
    """Phase 20 (b)-(d)'s one-process steps and eval, then the ranks'
    (``wait``) against them."""
    ones = {}
    for key in SP_TWO_KEYS:
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        one = sp_step(key, batch)
        torch.cuda.synchronize()
        ones[key] = one, read_launches(), torch.cuda.max_memory_allocated() - base
    one_eval = sp_eval_one(one_dir)
    ranks, secs = wait()
    errors = [r["error"] for r in ranks if "error" in r]
    if errors:
        fail(f"phase 20: SP on 2 ranks: {errors}")
    runs, report = [], {"seconds": secs, "rank_seconds": ranks[0]["seconds"]}
    for key in SP_TWO_KEYS:
        label = sp_label(key)
        rows = 1 if key == "TEDM" else SP_CL_ROWS if key in (*SP_CL, "finetune") else TP_ROWS
        one, one_counts, one_peak = ones[key]
        mixed = "--mixed_precision" in key or key == "finetune"
        loss_tol, grad_tol = (BF16_STEP_LOSS_TOL, BF16_STEP_GRAD_TOL) if mixed else (STEP_LOSS_TOL, STEP_GRAD_TOL)
        r0, r1 = ranks[0][key], ranks[1][key]
        loss_err = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
        grad_errs = {n: rel_err(r0["grads"][n], g) for n, g in one["grads"].items()}
        worst = max(grad_errs, key=grad_errs.get)
        same = r0["loss"] == r1["loss"] and all(torch.equal(v, r1["params"][n]) for n, v in r0["params"].items())
        peaks = [r[key]["peak_bytes"] for r in ranks]
        h = batch["x"].shape[2]
        print(f"phase 20 SP of 2 ranks on the one card over gloo, mesh 1 x 2 over data and spatial ({h // 2} of {h} "
              f"rows a rank), {label} at batch {rows} against one process on the same batch: "
              f"loss {r0['loss']:.6f} vs {one['loss']:.6f} (relative {loss_err:.2e}, tol {loss_tol}); gradients of "
              f"{len(grad_errs)} tensors, worst relative to the tensor's largest entry {grad_errs[worst]:.2e} at "
              f"{worst} (tol {grad_tol}); both ranks' loss and parameters equal: {same}; launches on rank 0 "
              f"{({k: v for k, v in r0['counts'].items() if v})}, rank 1 "
              f"{({k: v for k, v in r1['counts'].items() if v})}, one process "
              f"{({k: v for k, v in one_counts.items() if v})}; peak memory a rank {[round(p / 2**30, 3) for p in peaks]} "
              f"GiB, one process {one_peak / 2**30:.3f} GiB (the same step, above what the process held before it)",
              flush=True)
        if not (math.isfinite(one["loss"]) and loss_err <= loss_tol and grad_errs[worst] <= grad_tol):
            fail(f"phase 20: the 2-rank SP {label} disagrees with one process")
        if not same:
            fail(f"phase 20: the 2-rank SP {label}: the ranks hold different parameters")
        if r0["counts"] != one_counts or r1["counts"] != one_counts:
            fail(f"phase 20: the 2-rank SP {label}: launches {r0['counts']}, {r1['counts']} != one process's "
                 f"{one_counts}")
        runs.append((f"{label.replace(' step', '')} SP 1x2 (gloo)", r0["counts"]))
        report[label] = {"loss_rel_err": loss_err, "worst_grad_rel_err": grad_errs[worst], "worst_at": worst,
                         "launches": {k: v for k, v in r0["counts"].items() if v},
                         "peak_bytes_per_rank": peaks, "one_process_peak_bytes": one_peak}
    print(f"phase 20 SP of 2 ranks over gloo: {secs:.1f} s from its hand-over (beside the world of one), "
          f"{ranks[0]['seconds']:.1f} s in rank 0's steps "
          "(gloo copies each halo, gathered map and sum through the host: not a cost of SP on NCCL)", flush=True)
    runs_d, report["run_tests"] = sp_eval_against_one(ranks, sp_dir, one_dir, one_eval)
    return runs + runs_d, report


def sp_cl_inputs() -> dict:
    """Phase 20 (c)'s images from the seed: SP_CL_ROWS unlabelled ones for
    the CL steps and SP_CL_ROWS labelled ones for the finetune step."""
    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset
    from tedm_tpu_torch.trainers.common import to_nchw

    size = tp_config().img_size
    data = SyntheticCXRDataset("cxr_train", SP_CL_ROWS, size, labelled=False, seed=SEED + 20)
    img, mask = zip(*(SyntheticCXRDataset("train", SP_CL_ROWS, size, labelled=True, seed=SEED + 20)[i]
                      for i in range(SP_CL_ROWS)))
    return {"cl_x": to_nchw(np.stack([data[i] for i in range(SP_CL_ROWS)]), "cpu"),
            "ft_x": to_nchw(np.stack(img), "cpu"), "ft_y": to_nchw(np.stack(mask), "cpu")}


def sp_cl_step(key, batch, dp=None) -> dict:
    """One phase-20 (c) step at full width on the card from the seeded init,
    in one process or on a rank of ``dp``'s mesh: global_cl or local_cl
    (fp32, its views built from the whole images by a card generator seeded
    alike in every process, LocalCL's region centres drawn after them), or
    "finetune" (glob_loc_finetune's baseline UNet in bf16, its encoder
    frozen). The loss, the trained tensors' gradients and the parameters."""
    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.trainers import contrastive
    from tedm_tpu_torch.trainers.baseline import BaselineTask
    from tedm_tpu_torch.trainers.common import make_train_step

    if key == "finetune":
        cfg = config_from_args(["--experiment", "glob_loc_finetune", "--mixed_precision", "--seed", str(SEED),
                                "--log_dir", tempfile.gettempdir()])
        task = contrastive.build_task(cfg, "cuda")
        model, frozen = task.unet, contrastive.frozen_parameters(task)
        task = task if dp is None else BaselineTask(unet=dp.wrap(model, find_unused=True))
        step = make_train_step(task, torch.optim.Adam(model.parameters(), lr=cfg.lr), frozen, dp)
        loss, _ = step(batch["ft_x"].cuda(), batch["ft_y"].cuda(), torch.ones(SP_CL_ROWS, device="cuda"), freeze=True)
        held = {id(p) for p in frozen}
    else:
        cfg = config_from_args(["--experiment", key, "--seed", str(SEED), "--log_dir", tempfile.gettempdir()])
        model = contrastive.build_model(cfg, "cuda")
        contrastive.trainable_parameters(model)
        optimizer = torch.optim.Adam([p for p in model.parameters() if p.requires_grad], lr=cfg.lr)
        steps = contrastive.make_steps(cfg, model, optimizer, model if dp is None else dp.wrap(model), dp)
        loss = steps.train_step(batch["cl_x"].cuda(), torch.Generator(device="cuda").manual_seed(SEED))
        held = set()
    return {"loss": loss.item(),
            "grads": {n: p.grad.float().cpu() for n, p in model.named_parameters()
                      if p.grad is not None and id(p) not in held},
            "params": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def sp_cl_world_of_one() -> tuple:
    """Phase 20 (c) in a world of one under NCCL on a (1, 1) data x spatial
    mesh: each step against no group, bit for bit, launches equal."""
    from tedm_tpu_torch.parallel import mesh

    mesh.init_multihost("cuda")
    mesh.make_mesh((1, 1), ("data", "spatial"))
    batch = sp_cl_inputs()
    runs, report = [], {}
    for key in SP_CL:
        reset_launches()
        one = sp_cl_step(key, batch)
        one_counts = read_launches()
        reset_launches()
        got = sp_cl_step(key, batch, mesh.DataParallel("replicated", shard_spatial=True))
        counts = read_launches()
        same = got["loss"] == one["loss"] and all(torch.equal(v, one["params"][k]) for k, v in got["params"].items())
        print(f"phase 20 (c) {sp_label(key)} SP on a 1 x 1 mesh (world of one, NCCL): loss {got['loss']:.6f} against "
              f"{one['loss']:.6f} without a group; loss and parameters bit for bit: {same}; launches "
              f"{({k: v for k, v in counts.items() if v})} (without a group {({k: v for k, v in one_counts.items() if v})})",
              flush=True)
        if not same or counts != one_counts:
            fail(f"phase 20 (c) {sp_label(key)}: the world of one is not the run without a group")
        runs.append((f"{sp_label(key)} SP 1x1", counts))
        report[key] = {"loss": got["loss"], "bitwise": same}
    return runs, report


def sp_eval_dirs(out) -> tuple:
    """Phase 20 (d)'s experiment: a seeded TEDM head (its backbone seeded
    too) whose config shards spatially over (1, 2), at batch 2; the same
    run copied for the one-process eval."""
    import shutil

    from tedm_tpu_torch.config import config_from_args
    from tedm_tpu_torch.trainers import datasetdm
    from tedm_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = config_from_args(["--experiment", "TEDM", "--n_labelled_images", "1", "--batch_size", "2", "--synthetic_data",
                            "--seed", str(SEED), "--saved_diffusion_model", os.path.join(out, "none"),
                            "--mesh_shape", "1", "2", *SP_AXES, "--log_dir", os.path.join(out, "eval", "sp")])
    task = datasetdm.build_task(cfg, "cpu")
    save_checkpoint(os.path.join(cfg.log_dir, "best"), {k: m.state_dict() for k, m in task.modules.items()}, cfg)
    one = os.path.join(out, "eval", "one")
    shutil.copytree(cfg.log_dir, one)
    return cfg.log_dir, one


@contextlib.contextmanager
def small_eval_sets():
    """run_tests over the first SP_EVAL_ROWS images of each set."""
    from tedm_tpu_torch.data.pipeline import Loader
    from tedm_tpu_torch.eval import run_tests

    build = run_tests.build_test_loaders
    run_tests.build_test_loaders = lambda config, *a, **k: {
        n: Loader(v.dataset, config.batch_size, num_workers=1, subset=SP_EVAL_ROWS) for n, v in build(config, *a, **k).items()}
    try:
        yield
    finally:
        run_tests.build_test_loaders = build


def sp_step(key, batch, dp=None) -> dict:
    """One step of phase 20 (b)-(c) by its key: a backbone path's flags,
    "TEDM", a CL arm or "finetune"; in one process or on a rank of ``dp``'s
    mesh. The loss, the gradients and the parameters."""
    if key in (*SP_CL, "finetune"):
        return sp_cl_step(key, batch, dp)
    step = tp_head_step(batch, dp) if key == "TEDM" else tp_backbone_step(batch, key, dp)
    step.pop("module", None)
    step.pop("backbone", None)
    return step


def sp_label(key) -> str:
    if key == "TEDM":
        return "--use_pallas_groupnorm TEDM head step"
    if key == "finetune":
        return "glob_loc_finetune bf16 step"
    if key in SP_CL:
        return f"{key} fp32 step"
    return label_of("--mixed_precision" in key, tuple(f for f in key if f != "--mixed_precision")) + "backbone step"


def sp_rank_eval(eval_dir) -> dict:
    """Phase 20 (d) on a rank: run_tests --multihost over ``eval_dir``."""
    from tedm_tpu_torch.eval import run_tests

    reset_launches()
    t0 = time.perf_counter()
    with small_eval_sets(), contextlib.redirect_stdout(io.StringIO()):
        run_tests.main(["-e", eval_dir, "--multihost", "--rerun"], device="cuda")
    torch.cuda.synchronize()
    return {"counts": read_launches(), "seconds": time.perf_counter() - t0}


def sp_eval_one(one_dir) -> dict:
    """Phase 20 (d)'s one-process run_tests over ``one_dir``: its launches."""
    from tedm_tpu_torch.eval import run_tests

    reset_launches()
    with small_eval_sets(), contextlib.redirect_stdout(io.StringIO()):
        run_tests.main(["-e", one_dir, "--rerun"], device="cuda")
    return read_launches()


def sp_eval_against_one(ranks, sp_dir, one_dir, one_counts) -> tuple:
    """Phase 20 (d): each npz of the 2-rank run against the one-process
    run's (``sp_eval_one``)."""
    from tedm_tpu_torch.eval import harness as H

    errs, metric_errs = {}, {}
    for key in EVAL_SETS:
        a = H.load_output(os.path.join(sp_dir, f"{key}_predictions.npz"))
        b = H.load_output(os.path.join(one_dir, f"{key}_predictions.npz"))
        if a["y_hat"].shape != b["y_hat"].shape or not np.array_equal(a["y_star"], b["y_star"]):
            fail(f"phase 20 (d) {key}: the 2-rank npz holds other images than one process's")
        errs[key] = float(np.abs(a["y_hat"] - b["y_hat"]).max())
        # NaN (an empty denominator) on both sides agrees, on one side does not
        diff = lambda m: np.where(np.isnan(a[m]) & np.isnan(b[m]), 0.0, np.nan_to_num(np.abs(a[m] - b[m]), nan=np.inf))
        metric_errs[key] = max(float(diff(m).max()) for m in ("dice", "precision", "recall"))
    r0 = ranks[0]["eval"]
    print(f"phase 20 (d) run_tests of a TEDM head whose config shards spatially, 2 ranks over gloo at 1 x 2 "
          f"({SP_EVAL_ROWS} images of each set, batch 2, {r0['seconds']:.1f} s on rank 0) against one process: "
          f"largest probability difference by set {errs} (tol {PATH_TOL}); largest metric difference by set "
          f"{metric_errs} (tol {SP_METRIC_TOL}); launches on rank 0 {({k: v for k, v in r0['counts'].items() if v})}, "
          f"one process {({k: v for k, v in one_counts.items() if v})}", flush=True)
    if max(errs.values()) > PATH_TOL or max(metric_errs.values()) > SP_METRIC_TOL:
        fail("phase 20 (d): the sharded run_tests disagrees with one process")
    if r0["counts"] != one_counts or ranks[1]["eval"]["counts"] != one_counts:
        fail(f"phase 20 (d): launches {r0['counts']} != one process's {one_counts}")
    return [("TEDM eval SP 1x2 (gloo)", r0["counts"])], {"probability_max_abs_err": errs,
                                                          "metric_max_abs_err": metric_errs,
                                                          "rank_seconds": r0["seconds"]}


def phase_20(tmp, pair):
    """Phase 20: the spatial mesh axis (--shard_spatial) in a world of one
    and on 2 gloo ranks (``pair``, beside the world of one)."""
    import torch.distributed as dist

    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()), "RANK": "0", "WORLD_SIZE": "1",
           "LOCAL_RANK": "0"}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cudnn = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        finish_two = sp_two_ranks(tmp, pair)
        runs, report = sp_world_of_one(tmp)
        runs_c, report["contrastive, world of one"] = sp_cl_world_of_one()
        runs += runs_c
        if dist.is_initialized():
            dist.destroy_process_group()
        runs2, report["two ranks (gloo)"] = finish_two()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return runs + runs2, report


HOST_SIZES = [((2048, 2048), (128, 128)), ((1024, 1024), (128, 128)), ((256, 256), (128, 128)),
              ((100, 173), (128, 128)), ((131, 67), (37, 91))]  # phase 21 (b): (in, out) of each resize
HOST_PNG_MODES = ("gray8", "gray16", "gray16_alpha", "rgb", "rgba", "palette", "bit1")
HOST_CXR14, HOST_JSRT = (64, 1024), (16, 2048)  # phase 21 (c): files and their side
HOST_SCR_SIDE = 1024           # SCR's lung masks (van Ginneken et al. 2006, Med. Image Anal. 10(1)): 1024^2
HOST_JSRT_ROWS = 64            # rows of the JSRT split, cycling over its 16 files: 4 batches an epoch
HOST_BATCHES = {"CXR14": 6, "JSRT": 4}  # timed batches of each run, after its first
HOST_ORDER = ("pil", "native", "native", "pil", "pil", "native")  # the runs of each corpus, in turns


def host_png_cases(d) -> dict:
    """One PNG of each mode that a reader may meet, written by PIL (and the
    16-bit gray + alpha one by hand: PIL writes no LA;16B)."""
    import struct
    import zlib

    from PIL import Image

    rs = np.random.RandomState(SEED)
    rgb = Image.fromarray(rs.randint(0, 256, (150, 200, 3), np.uint8), "RGB")
    imgs = {"gray8": Image.fromarray(rs.randint(0, 256, (220, 180), np.uint8), "L"),
            "gray16": Image.fromarray(rs.randint(0, 2**16, (120, 90)).astype(np.uint16)),
            "rgb": rgb, "rgba": Image.fromarray(rs.randint(0, 256, (150, 200, 4), np.uint8), "RGBA"),
            "palette": rgb.convert("P", palette=Image.ADAPTIVE),
            "bit1": Image.fromarray(rs.randint(0, 256, (99, 77), np.uint8), "L").convert("1")}
    paths = {}
    for mode in HOST_PNG_MODES:
        paths[mode] = os.path.join(d, f"{mode}.png")
        if mode in imgs:
            imgs[mode].save(paths[mode])
            continue
        g = rs.randint(0, 2**16, (70, 50)).astype(np.uint16)
        raw = b"".join(b"\x00" + row.tobytes() for row in np.stack([g, np.full_like(g, 65535)], -1).astype(">u2"))
        chunk = lambda tag, data: (struct.pack(">I", len(data)) + tag + data
                                   + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
        with open(paths[mode], "wb") as f:
            f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 50, 70, 16, 4, 0, 0, 0))
                    + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    return paths


def host_bytes(native, d) -> list:
    """Phase 21 (b): the library against this machine's Pillow, byte for
    byte; the cases held."""
    from PIL import Image

    filters = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR, "nearest": Image.NEAREST}
    held = []
    for (h, w), (oh, ow) in HOST_SIZES:
        img = np.random.RandomState(h + w).randint(0, 256, (h, w), dtype=np.uint8)
        for name, filt in filters.items():
            got, want = native.resize_u8(img, (oh, ow), name), np.asarray(Image.fromarray(img).resize((ow, oh), filt))
            if not np.array_equal(got, want):
                fail(f"native resize {name} ({h}x{w} -> {oh}x{ow}) differs from Pillow's in "
                     f"{int((got != want).sum())} bytes")
            held.append(f"resize {name} {h}x{w}->{oh}x{ow}")
    if native.flavor() != "png":
        return held
    cases = host_png_cases(d)
    out, ok = native.load_resize_png_batch(list(cases.values()), (128, 128))
    for (mode, path), row, row_ok in zip(cases.items(), out, ok):
        got = native.load_resize_png(path, (128, 128))
        with Image.open(path) as img:
            want = np.asarray(img.convert("L").resize((128, 128)))
        if got is None or not row_ok:
            fail(f"native PNG route refused the {mode} file")
        if not (np.array_equal(got, want) and np.array_equal(row, want)):
            fail(f"native PNG route differs from Pillow's on the {mode} file in {int((got != want).sum())} bytes")
        held.append(f"png {mode} -> 128x128 (one file and the batch)")
    return held


def host_corpora(root) -> dict:
    """Phase 21 (c)'s corpora, by scripts/port/export_corpus.py's writer:
    CXR14's layout with 64 PNGs at 1024^2, and JSRT's with 16 PNGs at
    2048^2 and their two GIF lungs at SCR's 1024^2 (the mask taken at every
    other pixel), whose split cycles over them in 64 rows.
    Returns each corpus's ``build_dataloaders`` arguments."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "port"))
    import export_corpus as ec

    from tedm_tpu_torch.data.datasets import SyntheticCXRDataset

    cxr, jsrt = os.path.join(root, "cxr14"), os.path.join(root, "jsrt")
    for d in (os.path.join(cxr, "CXR14"), os.path.join(cxr, "data"), os.path.join(jsrt, "JSRT", "images"),
              os.path.join(jsrt, "data"), *(os.path.join(jsrt, "JSRT", "SCR", "masks", lab)
                                            for lab in ("right lung", "left lung"))):
        os.makedirs(d, exist_ok=True)
    cxr_ds = SyntheticCXRDataset("cxr_train", HOST_CXR14[0], HOST_CXR14[1], labelled=False, seed=SEED)
    jsrt_ds = SyntheticCXRDataset("train", HOST_JSRT[0], HOST_JSRT[1], labelled=True, seed=SEED)

    def cxr_file(i):
        ec._save_png(os.path.join(cxr, "CXR14", f"cxr_{i:05d}.png"), cxr_ds[i])

    def jsrt_file(i):
        img, mask = jsrt_ds[i]
        iid = f"train_{i:04d}"
        ec._save_png(os.path.join(jsrt, "JSRT", "images", iid + ".png"), img)
        step = HOST_JSRT[1] // HOST_SCR_SIDE
        for lab, m in zip(("right lung", "left lung"), ec._split_lungs(mask[::step, ::step])):
            ec._save_gif(os.path.join(jsrt, "JSRT", "SCR", "masks", lab, iid + ".gif"), m)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        list(pool.map(cxr_file, range(HOST_CXR14[0])))
        list(pool.map(jsrt_file, range(HOST_JSRT[0])))
    ec._write_csv(os.path.join(cxr, "data", "train_split.csv"), ("Image Index",),
                  [{"Image Index": f"cxr_{i:05d}.png"} for i in range(HOST_CXR14[0])])
    rows = [{"path": f"images/train_{i % HOST_JSRT[0]:04d}.png", "id": f"train_{i % HOST_JSRT[0]:04d}"}
            for i in range(HOST_JSRT_ROWS)]
    for split in ("train", "val", "test"):
        ec._write_csv(os.path.join(jsrt, "data", f"JSRT_{split}_split.csv"), ("path", "id"), rows)
    return {"CXR14": (os.path.join(cxr, "CXR14"), os.path.join(cxr, "data")),
            "JSRT": (os.path.join(jsrt, "JSRT"), os.path.join(jsrt, "data"))}


def host_reader_run(dataset, data_dir, splits_dir, route, workers) -> tuple:
    """One run of the port's train loader over a corpus (batch 16 at
    128^2) with the library (``native``) or without (``pil``,
    ``TEDM_NATIVE=0``): ms a batch over HOST_BATCHES batches after the
    first, and the batches."""
    from tedm_tpu_torch.data.pipeline import build_dataloaders

    os.environ["TEDM_NATIVE"] = "1" if route == "native" else "0"
    try:
        batches = build_dataloaders(dataset, data_dir, 128, 16, workers, seed=SEED, splits_dir=splits_dir)["train"]
        it = batches.repeat()
        got = [next(it)]
        t0 = time.perf_counter()
        got += [next(it) for _ in range(HOST_BATCHES[dataset])]
        ms = 1e3 * (time.perf_counter() - t0) / HOST_BATCHES[dataset]
        it.close()
    finally:
        del os.environ["TEDM_NATIVE"]
    return ms, got


def host_image_path(tmp, steps) -> dict:
    """Phase 21: the native library's build, its bytes against this
    machine's Pillow, and the port's readers with and without it beside the
    step each corpus feeds: ``steps`` = {corpus: (step's name, its ms)}."""
    import PIL

    from tedm_tpu_torch import native
    from tedm_tpu_torch.config import Config

    d = os.path.join(tmp, "host")
    os.makedirs(d)
    t0 = time.perf_counter()
    _, fresh_flavor, png_error = native.build(os.path.join(d, "_build"))  # a fresh directory: g++ runs
    build_s = time.perf_counter() - t0
    if not native.available():
        fail(f"the native library is not available on this machine:\n{native._LIBRARY.error}")
    print(f"(a) g++ built the {fresh_flavor} library in {build_s:.2f} s; the port's own library: "
          f"{native.flavor()}", flush=True)
    if png_error:
        print(f"(a) libpng's headers are here but the PNG build failed, so the PNG route goes unheld on this "
              f"card:\n{png_error}", flush=True)
    elif native.flavor() != "png":
        print("(a) libpng's headers are missing on this machine: the PNG route goes unheld on this card", flush=True)

    held = host_bytes(native, d)
    print(f"(b) Pillow {PIL.__version__}: the library equals it byte for byte in {len(held)} cases: "
          f"{'; '.join(held)}", flush=True)

    t0 = time.perf_counter()
    corpora = host_corpora(os.path.join(d, "corpora"))
    print(f"(c) corpora written in {time.perf_counter() - t0:.1f} s", flush=True)
    workers = Config().num_workers
    threads = min(16, os.cpu_count() or 1) if native.flavor() == "png" else 0  # the PNG batch route's
    report = {"build_s": build_s, "flavor": native.flavor(), "png_route_held": native.flavor() == "png",
              "pillow": PIL.__version__, "held": held, "loader_threads": workers,
              "native_batch_threads": threads, "cpu_count": os.cpu_count(),
              "png_build_error": png_error, "mask_side": HOST_SCR_SIDE}
    for dataset, (data_dir, splits_dir) in corpora.items():
        runs, ref = {"pil": [], "native": []}, None
        for route in HOST_ORDER:
            ms, got = host_reader_run(dataset, data_dir, splits_dir, route, workers)
            runs[route].append(ms)
            ref = ref or got
            for i, (a, b) in enumerate(zip(got, ref)):
                for k in b:
                    if not np.array_equal(a[k], b[k]):
                        fail(f"{dataset} batch {i} '{k}' through the {route} route differs from the pil route's")
        per = {r: statistics.median(v) for r, v in runs.items()}
        step_name, step_ms = steps[dataset]
        report[dataset] = {"ms": runs, "median_ms": per, "step": step_name, "step_ms": step_ms,
                           "share_of_step": {r: v / step_ms for r, v in per.items()}}
        n, side = HOST_CXR14 if dataset == "CXR14" else HOST_JSRT
        lungs = f", 2 GIF lungs each at {HOST_SCR_SIDE}^2" if dataset == "JSRT" else ""
        print(f"(c) {dataset} ({n} files at {side}^2{lungs}) -> "
              f"batch 16 at 128^2, {workers} loader threads, {threads} native batch threads, "
              f"{os.cpu_count()} cores: ms a batch (runs in turns {HOST_ORDER}) pil "
              f"{[round(x, 3) for x in runs['pil']]}, native {[round(x, 3) for x in runs['native']]}; "
              f"medians {per['pil']:.3f} / {per['native']:.3f} ms = {per['pil'] / step_ms:.3f} / "
              f"{per['native'] / step_ms:.3f} of {step_name} ({step_ms:.3f} ms); "
              f"the routes' batches byte-equal", flush=True)
    return report


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
    from tedm_tpu_torch import native
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
        libraries = [_build.library_path(name) for name in sources]
        libraries += [native.library_path(flavor) for flavor in native.FLAVORS]  # phase 21's, built at first use
        for path in libraries:  # never reuse a library from an earlier run
            if os.path.exists(path):
                os.unlink(path)
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
        pair = RankPair()  # phases 18-20's two ranks reach the card beside phases 14-17
        try:
            with Phase("14. eval harness, baseline and PDDM on a corpus of files"):
                root = export_hard_corpus(tmp)
                evals, eval_report, base_dir = eval_harness(tmp, backbone, root)
            with Phase("15. contrastive arms: pretraining, finetunes, eval, serving"):
                cl_runs, cl_report = contrastive_arms(tmp, root)
            with Phase("16. samplers and the conditional eval"):
                cond_runs, cond_report, cond_dir = conditional_chain(tmp, root)
            with Phase("17. --no_pallas, CUDA graphs, export, the grid, --remat, --profile_dir"):
                runs17, report17 = phase_17(tmp, served, served16, os.path.dirname(backbone), backbone16, cond_dir)
            with Phase("18. data parallel in a world of one: DDP and FSDP against no group, layouts, eval"):
                runs18, report18, plain = phase_18(tmp, base_dir, root, pair)
            with Phase("19. the model mesh axis (TP) in a world of one and on 2 gloo ranks, the input backends"):
                runs19, report19 = phase_19(tmp, pair, plain)
            with Phase("20. the spatial mesh axis (--shard_spatial) in a world of one and on 2 gloo ranks"):
                runs20, report20 = phase_20(tmp, pair)
        finally:
            pair.close()
        with Phase("21. host image path: the native library's build and bytes, the readers beside a step"):
            report21 = host_image_path(tmp, {
                "CXR14": ("path (a)'s step (phase 5)", a32_ms),
                "JSRT": ("the baseline's step at batch 16 (phase 14)", eval_report["baseline step ms (batch 16)"])})

    paths = add_paths(("serving", served["launches"]), ("training (a)", a32), ("training (b)", b32),
                      ("bf16 serving", served16["launches"]), ("bf16 training (a)", a16),
                      ("bf16 training (b)", b16), *opt_in, *evals, *cl_runs, *cond_runs, *runs17, *runs18,
                      *runs19, *runs20)
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
        kern["op"] = OPS.get(kern["name"])  # its torch.library op; a backward is none
        if kern["launches"] == 0:
            fail(f"{kern['name']} was never launched on the main path")
    print(json.dumps({"kernels": kernels, "phase_14": eval_report, "phase_15": cl_report, "phase_16": cond_report,
                      "phase_17": report17, "phase_18": report18, "phase_19": report19,
                      "phase_20": report20, "phase_21": report21}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
