#!/usr/bin/env python3
"""The measurements behind the B.3 and B.1b designs, on one card.

    python3 scripts/port/kernel_sweeps.py

1. B.3 (GroupNorm+FiLM+SiLU): at every call shape of the default UNet
   (batch 8 and 16, fp32 and bf16, with FiLM) the two-pass route and the
   cluster route with 2, 4 and 8 CTAs a (batch, group) slab, each where its
   CTAs fit, held against the plain version and timed
   (``chip_smoke.device_ms``), beside the card's count of clusters of each
   shape it holds at once (cudaOccupancyMaxActiveClusters). The size
   ``groupnorm.gn_route`` takes is marked.
2. B.1b (the linear-attention backward): copies of
   ``csrc/linear_attention.cu`` built with other slice widths, block widths,
   pipeline depths and blocks an SM (its constants replaced), and one with
   the arithmetic of both passes stripped (the same loads and stores), at
   a training step's shapes, beside ``torch.add`` over the bytes of the
   first pass; each held against the plain backward, the stripped one
   excepted. A source line a replacement needs that is missing stops the
   script.

Prints a row a shape and one JSON line.
"""

from __future__ import annotations

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

# (slice width, warps a block, stages, blocks an SM) of the B.1b variants; the first is the source's
LA_VARIANTS = [(16, 8, 2, 2), (16, 4, 3, 3), (16, 4, 2, 4), (16, 8, 3, 1), (32, 8, 2, 1), (32, 4, 2, 2)]
LA_CONSTANTS = ("constexpr int W = {};", "constexpr int WARPS = {};", "constexpr int STAGES = {};",
                "constexpr int BWD_BLOCKS_PER_SM = {};")
# the arithmetic of each pass, replaced by a copy of what it staged: (the kernel, the text from
# this anchor to the next one after it, what takes its place)
STRIP = [
    ("grad_q(const float*", "    {  // softmax over d of each column, in place",
     "    __syncwarp();  // the slice is read: the next iteration may stage into it",
     """    {
      const int j = lane % W, d0 = lane / W, col0 = start + sl * W;
      for (int kk = 0; kk < D / LPC; ++kk)
        if (col0 + j < n) dqb[(long long)(d0 + LPC * kk) * n + col0 + j] = qs[(d0 + LPC * kk) * WP + j] + gs[(d0 + LPC * kk) * WP + j];
    }
"""),
    ("grad_kv(const float*", "    const int col0 = start + sl * W;\n    const bool valid = col0 + j < n;",
     "    __syncwarp();  // the slice is read: the next iteration may stage into it\n  }\n}",
     """    const int col0 = start + sl * W;
    const bool valid = col0 + j < n;
    for (int kk = 0; kk < D / LPC; ++kk)
      if (valid) {
        const int d = d0 + LPC * kk;
        dkb[(long long)d * n + col0 + j] = ps[d * WP + j];
        dvb[(long long)d * n + col0 + j] = ws[d * WP + j];
      }
"""),
]


def groupnorm_sweep(gen) -> list:
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for shape in dict.fromkeys(s for s, _ in chip_smoke.gn_calls(8) + chip_smoke.gn_calls(16)):
            inputs = chip_smoke.gn_inputs(gen, shape, dtype, True)
            b, c, h, w = shape
            x, size = inputs[0], inputs[0].element_size()
            ref = gn.group_norm_film_silu_reference(*inputs).float()
            path = gn.device_route(x, dtype == torch.bfloat16)
            row = {"shape": list(shape), "dtype": chip_smoke.dtype_name(dtype), "path_cluster": path.cluster, "ms": {},
                   "active_clusters": {}}
            for cluster in (0, 2, 4, 8):
                route = gn.Route(cluster, gn.cluster_smem(c, h * w, size, cluster)) if cluster else gn.TWO_PASS
                if route.smem > gn.SMEM_PER_CTA:
                    continue
                err = (gn._forward(*inputs, 8, 1e-5, route=route).float() - ref).abs().max().item()
                if not err <= chip_smoke.gate(dtype):
                    sys.exit(f"B.3 on {route} disagrees with its plain version at {shape} {dtype}: {err}")
                row["ms"][cluster] = chip_smoke.device_ms(lambda: gn._forward(*inputs, 8, 1e-5, route=route))
                if cluster:
                    row["active_clusters"][cluster] = gn._active_clusters(
                        x.device.index, int(dtype == torch.bfloat16), int(dtype == torch.bfloat16), gn._vec(x, 8),
                        cluster, route.smem)
            rows.append(row)
            label = lambda k: f"{k} CTAs [{row['active_clusters'][k]} at once]" if k else "two-pass"
            print(f"B.3 {shape} {row['dtype']}: " + " ".join(
                f"{label(k)}{'*' if k == path.cluster else ''} {ms * 1e3:.1f} us" for k, ms in row["ms"].items()),
                flush=True)
            del inputs, ref
    return rows


def build_variant(source: str, name: str, out_dir: str) -> ctypes.CDLL:
    path = os.path.join(out_dir, name + ".cu")
    with open(path, "w") as f:
        f.write(source)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", path[:-3] + ".so", path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(path[:-3] + ".so")
    lib.la_backward_f32.argtypes = la._library().la_backward_f32.argtypes
    lib.la_backward_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_backward_workspace_floats.restype = ctypes.c_longlong
    return lib


def backward_variants(out_dir: str) -> dict:
    with open(os.path.join(_build.CSRC, "linear_attention.cu")) as f:
        source = f.read()
    base = LA_VARIANTS[0]
    libs = {}
    for variant in LA_VARIANTS:
        text = source
        for pattern, old, new in zip(LA_CONSTANTS, base, variant):
            if pattern.format(old) not in text:
                sys.exit(f"linear_attention.cu has no line {pattern.format(old)!r}")
            text = text.replace(pattern.format(old), pattern.format(new))
        libs[variant] = build_variant(text, "la_" + "_".join(map(str, variant)), out_dir)
    text = source
    for kernel, start, end, body in STRIP:
        a = text.find(start, text.find(kernel))
        if text.find(kernel) < 0 or a < 0 or text.find(end, a) < 0:
            sys.exit(f"linear_attention.cu has no anchor {start!r} .. {end!r}")
        text = text[:a] + body + text[text.index(end, a):]
    libs["arithmetic stripped"] = build_variant(text, "la_stripped", out_dir)
    return libs


def backward_call(lib, q, k, v, g, ctx, stats, scale):
    b, h, d, n = q.shape
    dq, dk, dv = (torch.empty(q.shape, device=q.device) for _ in range(3))
    ws = torch.empty(lib.la_backward_workspace_floats(b * h, n), device=q.device)
    arrivals = torch.zeros(b * h, device=q.device, dtype=torch.int32)

    def run():
        err = lib.la_backward_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), ctx.data_ptr(), stats.data_ptr(),
                                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), arrivals.data_ptr(),
                                  q.stride(0), k.stride(0), v.stride(0), g.stride(0), b, h, n, scale,
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"backward variant launch failed with CUDA error {err}")
        return dq, dk, dv
    return run


def backward_sweep(gen, out_dir: str) -> list:
    libs = backward_variants(out_dir)
    scale = 32 ** -0.5
    rows = []
    for shape in chip_smoke.TRAIN_SHAPES:
        n = shape[-1]
        q, k = (torch.randn(shape, generator=gen, device="cuda") * 2 for _ in range(2))
        v = torch.randn(shape, generator=gen, device="cuda") * n
        g = torch.randn(shape, generator=gen, device="cuda")
        _, ctx, stats = la._forward(q, k, v, scale)
        ref = la.linear_attention_backward_reference(q, k, v, g, scale)
        row = {"shape": list(shape), "ms": {}}
        for key, lib in libs.items():
            run = backward_call(lib, q, k, v, g, ctx, stats, scale)
            if key != "arithmetic stripped":
                errs = [chip_smoke.rel_err(a, b) for a, b in zip(run(), ref)]
                if not max(errs) <= chip_smoke.LA_BWD_TOL:
                    sys.exit(f"B.1b variant {key} disagrees with the plain backward at {shape}: {errs}")
            row["ms"][str(key)] = chip_smoke.device_ms(run)
        out = torch.empty_like(q)
        row["ms"]["torch.add(q, g) (pass 1's bytes)"] = chip_smoke.device_ms(lambda: torch.add(q, g, out=out))
        rows.append(row)
        print(f"B.1b {shape}: " + ", ".join(f"{k} {ms:.4f} ms" for k, ms in row["ms"].items()), flush=True)
        del q, k, v, g, ctx, stats, ref
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no card: this script times kernels on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        gn_rows = groupnorm_sweep(gen)
        la_rows = backward_sweep(gen, tmp)
    print(json.dumps({"device": smi, "groupnorm": gn_rows, "linear_attention_backward": la_rows}))


if __name__ == "__main__":
    main()
