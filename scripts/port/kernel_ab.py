#!/usr/bin/env python3
"""B.1 (the linear-attention forward) and B.1b (its backward) against an earlier commit's kernels, on one card.

    python3 scripts/port/kernel_ab.py --parent DIR

DIR holds a checkout of the earlier commit (``git archive <commit> | tar -x
-C DIR``), whose ``linear_attention.cu`` has the C interface of commit
4c7182a (the three-launch forward, the two-pass backward with arrival
counters). Both commits' sources are built with the flags of
``kernels/_build.py``. At the 8 call shapes of the default UNet's linear
attention (a serving request's at batch 8 and a training step's at batch 16,
each shape called twice) both forwards are held against the plain forward
on the same inputs (out within ``chip_smoke.LA_TOL``), and at a training
step's shapes both backwards against the plain backward (within
``chip_smoke.LA_BWD_TOL`` of each gradient's largest entry, from this
commit's forward's saved tensors); then each pair is timed in turns, parent,
this, this, parent (``chip_smoke.device_ms``: median device time of 25
calls, CUDA events). Then fp32 requests of a full-width TEDM model (random
weights from the seed) through ``Predictor``, with B.1 as 4c7182a's wrapper
and kernel and as this commit's, in ten pairs of turns (parent, this, this,
parent, ...: each side first in half of them): the median host latency of
``REQUESTS`` requests a turn, the pairs this commit's side won, and a
verdict (faster or slower: it wins or loses at least 9 of 10 pairs and
the medians differ by more than the parent's interquartile range; else
unresolved); both requests' probabilities on fixed noise held within
``chip_smoke.PATH_TOL`` of each other. Prints a row a shape, the sums over
a request's and a step's calls, the shapes where this commit's kernel is
slower, the latencies, and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tedm_tpu_torch.kernels import _build  # noqa: E402
from tedm_tpu_torch.kernels import linear_attention as la  # noqa: E402

REQUESTS = 20  # timed requests a turn, after one untimed
PAIRS = 10     # pairs of request turns, parent and this


def build_parent(parent: str, out_dir: str, source: str | None = None, name: str = "la_parent") -> ctypes.CDLL:
    """The earlier commit's ``linear_attention.cu`` (or ``source``, a text
    of it) built with this commit's flags against its own headers, with its
    C interface's argument types."""
    csrc = os.path.join(parent, "tedm_tpu_torch", "kernels", "csrc")
    path = os.path.join(out_dir, name + ".cu")
    with open(path, "w") as f:
        if source is None:
            with open(os.path.join(csrc, "linear_attention.cu")) as g:
                source = g.read()
        f.write(source)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", path[:-3] + ".so", path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(path[:-3] + ".so")
    lib.la_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_workspace_floats.restype = ctypes.c_longlong
    lib.la_forward_f32.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 3
                                   + [ctypes.c_float, ctypes.c_void_p])
    lib.la_backward_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_backward_workspace_floats.restype = ctypes.c_longlong
    lib.la_backward_f32.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                                    + [ctypes.c_float, ctypes.c_void_p])
    return lib


def parent_forward(lib, calls: list | None = None):
    """4c7182a's ``linear_attention._forward`` on its kernel ``lib``: the
    same checks, allocations and C call, counted in
    ``linear_attention.launches`` and, where given, in ``calls[0]``."""
    def forward(q, k, v, scale):
        la._check(q, k, v)
        b, h, d, n = q.shape
        with torch.cuda.device(q.device):
            empty = functools.partial(torch.empty, device=q.device, dtype=torch.float32)
            out, ctx, stats = empty((b, h, d, n)), empty((b * h, d, d)), empty((b * h, 2, d))
            ws = empty(lib.la_workspace_floats(b * h, n))
            err = lib.la_forward_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctx.data_ptr(),
                                     stats.data_ptr(), ws.data_ptr(), q.stride(0), k.stride(0), v.stride(0), b, h,
                                     n, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
        la._raise_on(err, "parent forward")
        la.linear_attention.launches += 1
        if calls is not None:
            calls[0] += 1
        return out, ctx, stats
    return forward


def parent_backward_call(lib, q, k, v, g, ctx, stats, scale):
    """The earlier backward's C call, with the arguments its wrapper passed."""
    b, h, d, n = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ws = torch.empty(lib.la_backward_workspace_floats(b * h, n), device=q.device)
    arrivals = torch.zeros(b * h, device=q.device, dtype=torch.int32)

    def run():
        err = lib.la_backward_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), ctx.data_ptr(),
                                  stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
                                  arrivals.data_ptr(), q.stride(0), k.stride(0), v.stride(0), g.stride(0), b, h, n,
                                  scale, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent backward kernel launch failed with CUDA error {err}")
        return dq, dk, dv
    return run


def in_turns(parent, this) -> dict:
    p1, t1, t2, p2 = (chip_smoke.device_ms(fn) for fn in (parent, this, this, parent))
    return {"parent_ms": [p1, p2], "ms": [t1, t2]}


def mean(pair) -> float:
    return sum(pair) / len(pair)


def request_latency(lib, tmp: str) -> dict:
    """fp32 requests of a full-width TEDM model through ``Predictor`` with
    B.1 as 4c7182a's wrapper and kernel and as this commit's, in
    ``PAIRS`` pairs of turns (parent, this, this, parent, ...): each turn's
    median latency of ``REQUESTS`` requests after one untimed, and the
    verdict described in the module's docstring; fails unless each parent
    turn ran the parent's kernel 8 times a request and both requests'
    probabilities on fixed noise agree within ``chip_smoke.PATH_TOL``."""
    from tedm_tpu_torch.serve.app import Predictor
    from tedm_tpu_torch.utils.checkpoint import save_checkpoint

    state, cfg = chip_smoke.random_tedm(tmp)
    logs = os.path.join(tmp, "serve", "logs")
    save_checkpoint(os.path.join(logs, "TEDM", "1", "best"), state, cfg)
    del state
    rs = np.random.RandomState(chip_smoke.SEED)
    img = rs.rand(1, cfg.img_size, cfg.img_size, 1).astype(np.float32)
    noise = rs.randn(1, cfg.img_size, cfg.img_size, 1).astype(np.float32)
    predictor = Predictor(logs_root=logs, device="cuda")
    own, calls = la._forward, [0]
    forwards = {"parent": parent_forward(lib, calls), "this": own}
    probs, turns = {}, []
    try:
        for key in ("parent", "this", "this", "parent") * (PAIRS // 2):
            la._forward = forwards[key]
            probs.setdefault(key, predictor._probabilities(img, "TEDM", 1, noise=noise))
            predictor.predict(img, "TEDM", 1)
            before, latencies = calls[0], []
            for _ in range(REQUESTS):
                t0 = time.perf_counter()
                predictor.predict(img, "TEDM", 1)  # returns host numpy: synchronised
                latencies.append(1e3 * (time.perf_counter() - t0))
            ran = (calls[0] - before) / REQUESTS
            if ran != (8 if key == "parent" else 0):
                sys.exit(f"a {key} turn ran the parent's forward {ran} times a request")
            turns.append({"forward": key, "median_ms": statistics.median(latencies)})
            print(f"fp32 request, {key}'s B.1: median {turns[-1]['median_ms']:.3f} ms of {REQUESTS}", flush=True)
    finally:
        la._forward = own
    diff = float(np.abs(probs["parent"] - probs["this"]).max())
    if not diff <= chip_smoke.PATH_TOL:
        sys.exit(f"fp32 request probabilities with the parent's B.1 and this commit's differ by {diff}")
    by = {key: [t["median_ms"] for t in turns if t["forward"] == key] for key in forwards}
    parent_ms, this_ms = statistics.median(by["parent"]), statistics.median(by["this"])
    wins = sum(b["median_ms"] < a["median_ms"] if a["forward"] == "parent" else a["median_ms"] < b["median_ms"]
               for a, b in zip(turns[::2], turns[1::2]))
    q1, _, q3 = statistics.quantiles(by["parent"], n=4)
    apart = abs(this_ms - parent_ms) > q3 - q1
    verdict = ("faster" if wins >= 0.9 * PAIRS and apart else "slower" if wins <= 0.1 * PAIRS and apart
               else "unresolved")
    print(f"fp32 request latency: parent {parent_ms:.3f} ms, this {this_ms:.3f} ms (medians of {PAIRS} turns "
          f"each); this commit won {wins} of {PAIRS} pairs; the parent's interquartile range {q3 - q1:.3f} ms; "
          f"{verdict}; probabilities differ by {diff:.2e}", flush=True)
    return {"turns": turns, "parent_ms": parent_ms, "ms": this_ms, "pairs_won": wins, "parent_iqr_ms": q3 - q1,
            "verdict": verdict, "probs_max_abs_diff": diff}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="a checkout of the earlier commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no card: this script times kernels on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    scale = 32 ** -0.5
    fwd_rows, bwd_rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        lib = build_parent(args.parent, tmp)
        for shape in chip_smoke.SERVE_SHAPES + chip_smoke.TRAIN_SHAPES:
            b, h, d, n = shape
            q, k = (torch.randn(shape, generator=gen, device="cuda") * 2 for _ in range(2))
            v = torch.randn(shape, generator=gen, device="cuda") * n
            ref = la.linear_attention_reference(q, k, v, scale)
            parent = lambda: parent_forward(lib)(q, k, v, scale)[0]
            this = lambda: la._forward(q, k, v, scale)[0]
            errs = [(fn() - ref).abs().max().item() for fn in (parent, this)]
            if max(errs) > chip_smoke.LA_TOL:
                sys.exit(f"a linear-attention forward disagrees with the plain version at {shape}: {errs}")
            row = {"shape": list(shape), **in_turns(parent, this), "max_abs_err": errs,
                   "cuda_launches": [len(chip_smoke.call_launches(f"{key} forward {shape}", fn, chip_smoke.REPS))
                                     for key, fn in (("parent", parent), ("this", this))]}
            fwd_rows[shape] = row
            print(f"linear_attention forward {shape}: parent {row['parent_ms'][0]:.4f} {row['parent_ms'][1]:.4f} ms, "
                  f"this {row['ms'][0]:.4f} {row['ms'][1]:.4f} ms, {mean(row['parent_ms']) / mean(row['ms']):.2f}x; "
                  f"CUDA launches {row['cuda_launches'][0]} -> {row['cuda_launches'][1]}; "
                  f"errors {errs[0]:.2e}, {errs[1]:.2e}", flush=True)
            if b == 16:
                g = torch.randn(shape, generator=gen, device="cuda")
                _, ctx, stats = la._forward(q, k, v, scale)
                ref = la.linear_attention_backward_reference(q, k, v, g, scale)
                parent = parent_backward_call(lib, q, k, v, g, ctx, stats, scale)
                this = lambda: la._backward(q, k, v, g, ctx, stats, scale)
                errs = [max(chip_smoke.rel_err(a, r) for a, r in zip(fn(), ref)) for fn in (parent, this)]
                if max(errs) > chip_smoke.LA_BWD_TOL:
                    sys.exit(f"a linear-attention backward disagrees with the plain version at {shape}: {errs}")
                row = {"shape": list(shape), **in_turns(parent, this), "max_rel_err": errs}
                bwd_rows[shape] = row
                print(f"linear_attention backward {shape}: parent {row['parent_ms'][0]:.4f} "
                      f"{row['parent_ms'][1]:.4f} ms, this {row['ms'][0]:.4f} {row['ms'][1]:.4f} ms, "
                      f"{mean(row['parent_ms']) / mean(row['ms']):.2f}x; errors {errs[0]:.2e}, {errs[1]:.2e}",
                      flush=True)
                del g, ctx, stats
            del q, k, v, ref
        latency = request_latency(lib, tmp)
    total = lambda rows, keys: {"parent_ms": sum(mean(rows[s]["parent_ms"]) for s in keys),
                                "ms": sum(mean(rows[s]["ms"]) for s in keys)}
    sums = {"linear_attention forward, a request's 8 calls (batch 8)": total(fwd_rows, 2 * chip_smoke.SERVE_SHAPES),
            "linear_attention forward, a step's 8 calls (batch 16)": total(fwd_rows, 2 * chip_smoke.TRAIN_SHAPES),
            "linear_attention backward, a step's 8 calls (batch 16)": total(bwd_rows, 2 * chip_smoke.TRAIN_SHAPES)}
    for key, v in sums.items():
        print(f"{key}: parent {v['parent_ms']:.4f} ms, this {v['ms']:.4f} ms", flush=True)
    slower = [(kind, r["shape"]) for kind, rows in (("forward", fwd_rows), ("backward", bwd_rows))
              for r in rows.values() if min(r["ms"]) > max(r["parent_ms"])]
    print(f"shapes where this commit's kernel is slower in every turn: {slower}", flush=True)
    print(json.dumps({"device": smi, "sums": sums, "linear_attention": list(fwd_rows.values()),
                      "linear_attention_backward": list(bwd_rows.values()), "fp32_request": latency}))


if __name__ == "__main__":
    main()
