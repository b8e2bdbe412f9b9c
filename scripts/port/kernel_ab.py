#!/usr/bin/env python3
"""B.3 (GroupNorm+FiLM+SiLU) and B.1b (the linear-attention backward) against an earlier commit's kernels, on one card.

    python3 scripts/port/kernel_ab.py --parent DIR

DIR holds a checkout of the earlier commit (``git archive <commit> | tar -x
-C DIR``), whose ``groupnorm.cu`` and ``linear_attention.cu`` have the C
interfaces of commit d37fdaa (the two-pass B.3, the three-pass B.1b). Both
commits' sources are built with the flags of ``kernels/_build.py``. At every
call shape of the default UNet (B.3: its 38 GroupNorms at batch 8, a serving
request's, and 16, a training step's, in fp32 and bf16, with FiLM where the
call has it; B.1b: a training step's 8 backward calls at batch 16) both
kernels are held against the plain version on the same inputs
(``chip_smoke.gn_inputs`` within ``chip_smoke.gate``; B.1b within
``chip_smoke.LA_BWD_TOL`` of each gradient's largest entry, from the forward
kernel's saved tensors), then timed in turns, parent, this, this, parent
(``chip_smoke.device_ms``: median device time of 25 calls, CUDA events).
Prints a row a shape, the sums over a request's and a step's calls, the
shapes where this commit's kernel is slower, and one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tedm_tpu_torch.kernels import _build  # noqa: E402
from tedm_tpu_torch.kernels import groupnorm as gn  # noqa: E402
from tedm_tpu_torch.kernels import linear_attention as la  # noqa: E402


def build_parent(parent: str, name: str, out_dir: str) -> ctypes.CDLL:
    csrc = os.path.join(parent, "tedm_tpu_torch", "kernels", "csrc")
    lib_path = os.path.join(out_dir, f"{name}_parent.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib_path, os.path.join(csrc, name + ".cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib_path)


def parent_groupnorm(lib):
    lib.gn_workspace_floats.argtypes = [ctypes.c_int] * 3
    lib.gn_workspace_floats.restype = ctypes.c_longlong
    lib.gn_forward.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
                               + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_void_p] * 3)
    lib.gn_forward.restype = ctypes.c_int

    def call(x, gamma, beta, scale, shift):
        """The earlier kernel's call, with the arguments its wrapper passed."""
        b, c, h, w = x.shape
        gamma, beta = gamma.float().contiguous(), beta.float().contiguous()
        s, t, stride, bf16 = gn.film_rows(scale, shift, x, c)
        out = torch.empty_like(x)
        ws = torch.empty(lib.gn_workspace_floats(b, c, h * w), device=x.device)

        def run():
            err = lib.gn_forward(int(x.dtype == torch.bfloat16), int(bf16), x.data_ptr(), x.stride(0), gamma.data_ptr(),
                                 beta.data_ptr(), None if s is None else s.data_ptr(), None if t is None else t.data_ptr(),
                                 stride, b, c, 8, h * w, 1e-5, ws.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"parent groupnorm kernel launch failed with CUDA error {err}")
            return out
        return run
    return call


def parent_backward(lib):
    lib.la_backward_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_backward_workspace_floats.restype = ctypes.c_longlong
    lib.la_backward_f32.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 3
                                    + [ctypes.c_float, ctypes.c_void_p])
    lib.la_backward_f32.restype = ctypes.c_int

    def call(q, k, v, g, ctx, stats, scale):
        b, h, d, n = q.shape
        dq, dk, dv = (torch.empty_like(q) for _ in range(3))
        ws = torch.empty(lib.la_backward_workspace_floats(b * h, n), device=q.device)

        def run():
            err = lib.la_backward_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), ctx.data_ptr(),
                                      stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(),
                                      q.stride(0), k.stride(0), v.stride(0), g.stride(0), b, h, n, scale,
                                      torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"parent backward kernel launch failed with CUDA error {err}")
            return dq, dk, dv
        return run
    return call


def in_turns(parent, this) -> dict:
    p1, t1, t2, p2 = (chip_smoke.device_ms(fn) for fn in (parent, this, this, parent))
    return {"parent_ms": [p1, p2], "ms": [t1, t2]}


def mean(pair) -> float:
    return sum(pair) / len(pair)


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
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    gn_rows, la_rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        parent_gn = parent_groupnorm(build_parent(args.parent, "groupnorm", tmp))
        parent_la = parent_backward(build_parent(args.parent, "linear_attention", tmp))
        for dtype in (torch.float32, torch.bfloat16):
            for shape, film in dict.fromkeys(chip_smoke.gn_calls(8) + chip_smoke.gn_calls(16)):
                inputs = chip_smoke.gn_inputs(gen, shape, dtype, film)
                ref = gn.group_norm_film_silu_reference(*inputs).float()
                parent = parent_gn(*inputs)
                this = lambda: gn.fused_group_norm_film_silu(*inputs)
                errs = [(fn().float() - ref).abs().max().item() for fn in (parent, this)]
                if max(errs) > chip_smoke.gate(dtype):
                    sys.exit(f"a GroupNorm kernel disagrees with the plain version at {shape} {dtype}: {errs}")
                row = {"shape": list(shape), "dtype": chip_smoke.dtype_name(dtype), "film": film,
                       "cluster": gn.device_route(inputs[0], dtype == torch.bfloat16 and film).cluster,
                       **in_turns(parent, this), "max_abs_err": errs}
                gn_rows[(shape, dtype, film)] = row
                print(f"fused_group_norm_film_silu {shape} {row['dtype']} film={film} cluster {row['cluster']}: "
                      f"parent {row['parent_ms'][0]:.4f} {row['parent_ms'][1]:.4f} ms, this {row['ms'][0]:.4f} "
                      f"{row['ms'][1]:.4f} ms, {mean(row['parent_ms']) / mean(row['ms']):.2f}x", flush=True)
                del inputs, ref
        scale = 32 ** -0.5
        for shape in chip_smoke.TRAIN_SHAPES:
            n = shape[-1]
            q, k = (torch.randn(shape, generator=gen, device="cuda") * 2 for _ in range(2))
            v = torch.randn(shape, generator=gen, device="cuda") * n
            g = torch.randn(shape, generator=gen, device="cuda")
            _, ctx, stats = la._forward(q, k, v, scale)
            ref = la.linear_attention_backward_reference(q, k, v, g, scale)
            parent = parent_la(q, k, v, g, ctx, stats, scale)
            this = lambda: la._backward(q, k, v, g, ctx, stats, scale)
            errs = [max(chip_smoke.rel_err(a, b) for a, b in zip(fn(), ref)) for fn in (parent, this)]
            if max(errs) > chip_smoke.LA_BWD_TOL:
                sys.exit(f"a linear-attention backward disagrees with the plain version at {shape}: {errs}")
            row = {"shape": list(shape), **in_turns(parent, this), "max_rel_err": errs}
            la_rows[shape] = row
            print(f"linear_attention backward {shape}: parent {row['parent_ms'][0]:.4f} {row['parent_ms'][1]:.4f} ms, "
                  f"this {row['ms'][0]:.4f} {row['ms'][1]:.4f} ms, {mean(row['parent_ms']) / mean(row['ms']):.2f}x; "
                  f"errors {errs[0]:.2e}, {errs[1]:.2e}", flush=True)
            del q, k, v, g, ctx, stats, ref
    sums = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, batch in (("request", 8), ("step", 16)):
            calls = [gn_rows[(s, dtype, f)] for s, f in chip_smoke.gn_calls(batch)]
            key = f"fused_group_norm_film_silu, a {label}'s 38 calls ({chip_smoke.dtype_name(dtype)}, batch {batch})"
            sums[key] = {"parent_ms": sum(mean(r["parent_ms"]) for r in calls), "ms": sum(mean(r["ms"]) for r in calls)}
    calls = [la_rows[s] for s in 2 * chip_smoke.TRAIN_SHAPES]
    sums["linear_attention backward, a step's 8 calls (batch 16)"] = {
        "parent_ms": sum(mean(r["parent_ms"]) for r in calls), "ms": sum(mean(r["ms"]) for r in calls)}
    for key, v in sums.items():
        print(f"{key}: parent {v['parent_ms']:.4f} ms, this {v['ms']:.4f} ms", flush=True)
    slower = [r for r in list(gn_rows.values()) + list(la_rows.values()) if min(r["ms"]) > max(r["parent_ms"])]
    print(f"shapes where this commit's kernel is slower in every turn: {[(r['shape'], r.get('dtype')) for r in slower]}",
          flush=True)
    print(json.dumps({"device": smi, "sums": sums, "groupnorm": list(gn_rows.values()),
                      "linear_attention_backward": list(la_rows.values())}))


if __name__ == "__main__":
    main()
