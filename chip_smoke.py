#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tedm_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. environment: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: every CUDA source in tedm_tpu_torch/kernels/csrc, one nvcc per
     source, all started together;
  3. kernels vs plain: each kernel against its plain PyTorch version at the
     shapes the serving path gives it, with device times (CUDA events);
  4. main path: a full-width TEDM model (random weights from a seed) saved
     with the port's save_checkpoint and served through Predictor for 4
     requests; each kernel's launch count over those requests; one more
     request traced with torch.profiler (device time by kernel kind, the
     card's busy share); then one request's ensembled probabilities against
     the plain path on the CPU;
  5. one JSON line listing every kernel, then the final JSON status line.
"""

from __future__ import annotations

import json
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 rate outside the tensor cores
LA_TOL = 2e-5                  # fp32 kernel tolerance (KERNELS.json)
PATH_TOL = 1e-3                # card vs CPU plain path, ensembled probabilities
LA_SHAPES = [(8, 4, 32, n) for n in (256, 1024, 4096, 16384)]  # 2 calls each per request


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


# substrings of device kernel names -> the kind of work, for the profile
KERNEL_KINDS = (
    ("linear_attention kernel", ("context_partials", "combine_context", "apply_context")),
    ("convolution / gemm", ("conv", "cudnn", "xmma", "gemm", "fft", "pointwise_mult_and_sum_complex")),
    ("reduction / softmax / norm", ("reduce", "softmax", "norm")),
    ("elementwise / copy", ("elementwise", "copy", "cat", "index", "fill")),
)


def profile_request(predictor, img) -> None:
    """One request under torch.profiler: device time by kernel kind and by
    kernel, and the share of the request's wall time the card was busy.
    The profiler's own overhead inflates the wall time, so the busy share is
    a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor.predict(img, "TEDM", 1)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        fail("the profiler saw no device time")
    print(f"profile of one request: {sum(e.count for e in kernels)} kernel launches, device busy "
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script measures the port on a card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.kernels import _build
    from tedm_tpu_torch.kernels import linear_attention as la
    from tedm_tpu_torch.serve.app import Predictor
    from tedm_tpu_torch.trainers.datasetdm import build_task
    from tedm_tpu_torch.utils.checkpoint import save_checkpoint

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build every kernel from the checkout's sources
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC) if f.endswith(".cu"))
    for name in sources:  # never reuse a library from an earlier run
        if os.path.exists(_build.library_path(name)):
            os.unlink(_build.library_path(name))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        for name, path in zip(sources, pool.map(_build.build, sources)):
            print(f"built {name}: {os.path.relpath(path)}")
    print(f"build seconds: {time.perf_counter() - t0:.2f}", flush=True)

    # 3. linear attention kernel vs its plain version at the path's shapes
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scale = 32 ** -0.5
    per_shape = []
    for shape in LA_SHAPES:
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
        bytes_ms = 1e3 * 4 * q.numel() * 4 / HBM_BYTES_PER_S
        ops_ms = 1e3 * 2 * 2 * q.numel() * shape[2] / FP32_FLOPS_PER_S
        row = {
            "shape": list(shape),
            "max_abs_err": err,
            "max_abs_ref": ref.abs().max().item(),
            "ms": device_ms(lambda: la.linear_attention(q, k, v, scale)),
            "plain_ms": device_ms(lambda: la.linear_attention_reference(q, k, v, scale)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        per_shape.append(row)
        print(f"linear_attention {shape}: max_abs_err {err:.3e} (|ref| <= {row['max_abs_ref']:.3f}, "
              f"tol {LA_TOL}) kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} ms "
              f"bound {1e3 * row['bound_ms']:.2f} us", flush=True)
        if not err <= LA_TOL:
            fail(f"linear_attention kernel disagrees with its plain version at {shape}: {err}")
        del q, k, v, out, ref
    # edges the path does not reach: N off the kernel's tiles, one column,
    # one head, and the strided views of a qkv conv output
    edges = []
    for shape in [(1, 4, 32, 1), (2, 4, 32, 300), (3, 1, 32, 513), (1, 4, 32, 2 ** 16 + 7)]:
        q, k = (torch.randn(shape, generator=gen, device="cuda") * 2 for _ in range(2))
        edges.append((shape, q, k, torch.randn(shape, generator=gen, device="cuda") * shape[-1]))
    qkv = torch.randn(2, 3 * 128, 20, 20, generator=gen, device="cuda") * 2
    edges.append(("qkv views", *(t.reshape(2, 4, 32, 400) for t in qkv.chunk(3, dim=1))))
    for what, q, k, v in edges:
        err = (la.linear_attention(q, k, v, scale) - la.linear_attention_reference(q, k, v, scale)).abs().max().item()
        if not err <= LA_TOL:
            fail(f"linear_attention kernel disagrees with its plain version at {what}: {err}")
    del edges, qkv, q, k, v
    print("linear_attention edge shapes and qkv views: within tolerance", flush=True)

    # 4. main path: full-width TEDM served through the port's Predictor
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config(log_dir=os.path.join(tmp, "run")).replace(
            experiment="TEDM", n_labelled_images=1, seed=SEED,
            saved_diffusion_model=os.path.join(tmp, "no_backbone"),
        ).apply_experiment_preset()
        task = build_task(cfg, device="cuda")  # random weights from cfg.seed
        logs = os.path.join(tmp, "logs")
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

        la.linear_attention.launches = 0
        latencies, masks, launches = [], [], []
        for img in imgs:
            before = la.linear_attention.launches
            t0 = time.perf_counter()
            masks.append(predictor.predict(img, "TEDM", 1))  # returns host numpy: synchronised
            latencies.append(1e3 * (time.perf_counter() - t0))
            launches.append(la.linear_attention.launches - before)
        main_launches = la.linear_attention.launches
        peak = torch.cuda.max_memory_allocated()

        print(f"requests: {N_REQUESTS}; latency ms {[round(x, 3) for x in latencies]} "
              f"(the first includes loading the checkpoint); median of the rest "
              f"{statistics.median(latencies[1:]):.3f} ms; "
              f"linear_attention launches per request {launches}; "
              f"peak device memory {peak} bytes ({peak / 2**30:.3f} GiB)", flush=True)
        if launches != [8] * N_REQUESTS:
            fail(f"expected 8 linear_attention launches per request, got {launches}")
        profile_request(predictor, imgs[0])
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

    # 5. every kernel of the path; times summed over one request's 8 calls
    calls = 2  # each shape occurs once on the way down and once on the way up
    kernels = [{
        "name": "linear_attention",
        "route": "cuda",
        "source": "tedm_tpu_torch/kernels/csrc/linear_attention.cu",
        "replaces": "tedm_tpu/ops/pallas/linear_attention.py:122",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in per_shape),
        "ms": calls * sum(r["ms"] for r in per_shape),
        "plain_ms": calls * sum(r["plain_ms"] for r in per_shape),
        "bound_ms": calls * sum(r["bound_ms"] for r in per_shape),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in per_shape) else "operations",
        "library_ms": None,  # no single PyTorch call computes this function
        "per_shape": per_shape,
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
