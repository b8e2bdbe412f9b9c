#!/usr/bin/env python3
"""The port's sampling throughput on one card: ``bench.py``'s metric.

    python3 scripts/port/bench_sampling.py [--batch 8] [--steps 1000]

``ddpm_sampling_steps_per_sec_per_chip`` = (batch x reverse steps) / elapsed,
the metric of the JAX package's ``bench.py`` (bench.py:85-117): the
full-size backbone (UNet dim 64, mults (1, 2, 4, 8), 128x128, random
weights from seed 0), the ancestral loop over a cosine schedule of
``--steps`` timesteps with dynamic thresholding, batch 8. Timed by CUDA
events around the whole trajectory, after a warm-up of a few steps, in fp32
(TF32 off) and in bf16 (``--mixed_precision``'s compute dtype), each:

* eager: ``models.diffusion.sample_loop``, which draws x_T and each step's
  noise from a generator on the card;
* exported: the one-step program of ``serve.export.export_sampler(...,
  "ancestral")`` (a checkpoint of the same weights, loaded in this process by
  ``load_exported``) run over the grid, with the same noise drawn before the
  clock in the loop's order; its final sample is held against the eager
  one's (max abs difference printed, gated at ``chip_smoke.SAMPLER_TOL``).

Then the split of one reverse step (t = T - 1) three ways: eager; the raw
exported program (``torch.export.load(...).module()``, the
``aten._assert_tensor_metadata`` nodes that export writes before each dtype
cast kept); and the program as ``load_exported`` runs it (those nodes
dropped). For each: host ms a step over ``SPLIT_STEPS`` steps by CUDA
events, and under ``torch.profiler`` (``chip_smoke.profile``) one step's
device busy ms of its wall ms, kernel launches, host op calls and the host
ops by self time.

Prints the card's name and power limit, one line a run, and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

WARMUP_STEPS = 3
SPLIT_STEPS = 20


def timed_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def step_split(unet, sched, path: str, shape, kw: dict) -> dict:
    """One reverse step at t = T - 1 eagerly, through the raw exported
    program and through the program ``load_exported`` runs: host ms a step
    (CUDA events over SPLIT_STEPS steps) and one step under torch.profiler."""
    from torch.autograd import DeviceType

    import chip_smoke
    from tedm_tpu_torch.models import diffusion as D
    from tedm_tpu_torch.serve.export import _drop_metadata_asserts

    gen = torch.Generator(device="cuda").manual_seed(2)
    x, noise = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    t = torch.full((shape[0],), sched.num_timesteps - 1, dtype=torch.long, device="cuda")
    raw = torch.export.load(path).module()
    dropped = _drop_metadata_asserts(torch.export.load(path).module())
    ways = {"eager": lambda: D.sample_step(unet, sched, x, t, noise=noise, **kw),
            "exported_raw": lambda: raw(x, t, noise), "exported": lambda: dropped(x, t, noise)}
    out = {}
    with torch.no_grad():
        for name, step in ways.items():
            step()
            ms = timed_ms(lambda: [step() for _ in range(SPLIT_STEPS)]) / SPLIT_STEPS
            events = chip_smoke.profile(f"one {name} step", step)
            host = [e for e in events if e.device_type == DeviceType.CPU]
            top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]
            asserts = [e for e in host if e.key == "aten::_assert_tensor_metadata"]
            out[name] = {"host_ms_per_step": ms, **chip_smoke.profile.last,
                         "host_op_calls": sum(e.count for e in host),
                         "assert_calls": sum(e.count for e in asserts),
                         "assert_self_ms": sum(e.self_cpu_time_total for e in asserts) / 1e3,
                         "top_host_ops": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in top]}
            print(f"  {name}: {ms:.3f} ms a step (CUDA events over {SPLIT_STEPS}); host op calls "
                  f"{out[name]['host_op_calls']}, of them aten::_assert_tensor_metadata {out[name]['assert_calls']} "
                  f"({out[name]['assert_self_ms']:.3f} ms self, profiled); top host ops by self ms "
                  f"{[[k, n, round(v, 3)] for k, n, v in out[name]['top_host_ops']]}", flush=True)
    return out


def bench(dtype: torch.dtype, batch: int, steps: int, tmp: str) -> dict:
    import chip_smoke
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.models import diffusion as D
    from tedm_tpu_torch.ops.schedules import make_schedule
    from tedm_tpu_torch.serve.export import export_sampler, load_exported
    from tedm_tpu_torch.trainers.diffusion import build_model
    from tedm_tpu_torch.utils.checkpoint import save_checkpoint

    mixed = dtype == torch.bfloat16
    cfg = Config(experiment="img_only", timesteps=steps, mixed_precision=mixed, seed=0,
                 log_dir=os.path.join(tmp, "bf16" if mixed else "fp32"))
    unet = build_model(cfg).cuda().eval().requires_grad_(False)  # dim 64, (1, 2, 4, 8), from seed 0
    sched = make_schedule(steps, cfg.beta_schedule).to("cuda")
    shape = (batch, 1, cfg.img_size, cfg.img_size)
    kw = dict(objective=cfg.objective, dynamic_threshold_percentile=cfg.dynamic_threshold_percentile)

    # eager: a few steps to warm up, then the whole trajectory
    D.sample_loop(unet, make_schedule(WARMUP_STEPS, cfg.beta_schedule).to("cuda"), shape,
                  torch.Generator(device="cuda").manual_seed(1), **kw)
    out = {}
    eager_ms = timed_ms(lambda: out.setdefault("eager", D.sample_loop(
        unet, sched, shape, torch.Generator(device="cuda").manual_seed(0), **kw)))

    # exported: the one-step program over the grid, the same draws made before the clock
    save_checkpoint(os.path.join(cfg.log_dir, "best"), {"params": unet.state_dict()}, cfg)
    path = os.path.join(tmp, f"{'bf16' if mixed else 'fp32'}.pt2")
    t0 = time.perf_counter()
    size = export_sampler(cfg.log_dir, path, batch_size=batch, sampler="ancestral", device="cuda")
    export_s = time.perf_counter() - t0
    step = load_exported(path, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x_T = torch.randn(shape, generator=gen, device="cuda")
    noises = torch.stack([torch.randn(shape, generator=gen, device="cuda") for _ in range(steps)])
    step(x_T, noises[:WARMUP_STEPS], grid=list(range(WARMUP_STEPS - 1, -1, -1)))
    exported_ms = timed_ms(lambda: out.setdefault("exported", step(x_T, noises)))
    eager = D.unnormalize_to_zero_to_one(out["eager"].clamp(-1.0, 1.0)).cpu().numpy()
    err = float(abs(out["exported"] - eager).max())
    row = {
        "eager_steps_per_sec": batch * steps / (eager_ms / 1e3),
        "exported_steps_per_sec": batch * steps / (exported_ms / 1e3),
        "eager_ms": eager_ms, "exported_ms": exported_ms,
        "exported_vs_eager_max_abs": err, "export_s": export_s, "artifact_bytes": size,
    }
    print(f"{'bf16' if mixed else 'fp32'}: batch {batch}, {steps} steps: eager {eager_ms:.1f} ms "
          f"({row['eager_steps_per_sec']:.2f} steps/s), exported {exported_ms:.1f} ms "
          f"({row['exported_steps_per_sec']:.2f} steps/s); exported vs eager {err:.3e}; export {export_s:.1f} s, "
          f"{size} bytes", flush=True)
    if not err <= chip_smoke.SAMPLER_TOL:
        raise SystemExit(f"the exported sampler disagrees with the eager loop: {err}")
    print(f"{'bf16' if mixed else 'fp32'}: one step three ways", flush=True)
    row["split"] = step_split(unet, sched, path, shape, kw)
    return row


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=1000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no card: this script measures the port on one")
    from tedm_tpu_torch.utils.device import strict_fp32

    strict_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        rows = {name: bench(dtype, args.batch, args.steps, tmp)
                for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16))}
    print(json.dumps({"metric": "ddpm_sampling_steps_per_sec_per_chip", "card": card, "batch": args.batch,
                      "steps": args.steps, **rows}))


if __name__ == "__main__":
    main()
