#!/usr/bin/env python3
"""The measurements behind the B.3, B.1 and B.1b designs, on one card.

    python3 scripts/port/kernel_sweeps.py [--sections ...] [--parent DIR]

Sections, all but ``b1_parent`` by default:

- ``groupnorm``, B.3 (GroupNorm+FiLM+SiLU): at every call shape of the
  default UNet (batch 8 and 16, fp32 and bf16, with FiLM) the two-pass
  route and the cluster route with 2, 4 and 8 CTAs a (batch, group) slab,
  each where its CTAs fit, held against the plain version and timed
  (``chip_smoke.device_ms``), beside the card's count of clusters of each
  shape it holds at once (cudaOccupancyMaxActiveClusters). The size
  ``groupnorm.gn_route`` takes is marked.
- ``b1_parent``, B.1 (the linear-attention forward) at 4c7182a, from a
  checkout of it in DIR (``git archive 4c7182a | tar -x -C DIR``), built
  and called as ``kernel_ab.py`` does: its three launches timed apart at N
  = 16384 and 256, batch 8 and 16, the whole call, a copy with its
  arithmetic stripped (the same loads and stores), and ``torch.add`` over
  q and k.
- ``b1``, B.1 as it stands: both routes (two launches; one cluster launch
  of 1, 2, 4 or 8 CTAs a (b, h)) in copies of the source with its
  constants replaced (``CLUSTER``; slice width, warps, stages and blocks an
  SM) and its route forced (``forced_route``), and a copy with its
  arithmetic stripped, at the 8 path shapes, each held against the plain
  forward (the stripped copy excepted), then timed; each launch of the
  two-launch route and of the route the kernel takes timed apart at N =
  16384 and 256.
- ``b1_phases``, B.1's cluster launch phase by phase: globaltimer stamps in
  a copy of ``la_cluster``, forced onto the cluster route, the median over
  CTAs of each phase.
- ``b1b``, B.1b (the linear-attention backward): copies of
  ``csrc/linear_attention.cu`` built with other slice widths, block widths,
  pipeline depths and blocks an SM, and one with the arithmetic of both
  passes stripped, at a training step's shapes, beside ``torch.add`` over
  the bytes of the first pass; each held against the plain backward, the
  stripped one excepted.

A source line or anchor a copy needs that is missing stops the script.
Prints a row a shape and one JSON line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from kernel_ab import build_parent, parent_forward  # noqa: E402
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


def build_variant(source: str, name: str, out_dir: str, include: str = _build.CSRC) -> ctypes.CDLL:
    path = os.path.join(out_dir, name + ".cu")
    with open(path, "w") as f:
        f.write(source)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", include, "-o", path[:-3] + ".so", path],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(path[:-3] + ".so")
    lib.la_backward_f32.argtypes = la._library().la_backward_f32.argtypes
    lib.la_backward_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_backward_workspace_floats.restype = ctypes.c_longlong
    return lib


def backward_variants(out_dir: str) -> dict:
    with open(os.path.join(_build.CSRC, "linear_attention.cu")) as f:
        source = f.read()
    libs = {}
    for variant in LA_VARIANTS:
        text = replace_constants(source, LA_CONSTANTS, LA_VARIANTS[0], variant, "linear_attention.cu")
        libs[variant] = build_variant(text, "la_" + "_".join(map(str, variant)), out_dir)
    libs["arithmetic stripped"] = build_variant(strip(source, STRIP, "linear_attention.cu"), "la_stripped", out_dir)
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


# B.1 at 4c7182a: its three launches, and the arithmetic of the first and the last replaced by a
# use of what they load (the same loads and stores)
B1_PARENT_STRIP = [
    ("context_partials(const float*", "    // warp w owns rows 4w..4w+3: tile max, new running max, exp in place",
     "  }\n  float* out = partials +",
     "    acc[0][0] += ks[blk.d0][t % TILE] * vs[blk.e0][t % TILE];\n"),
    ("apply_context(const float*", "  softmax_d(s);", "}\n\n// ------",
     """  float* ob = out + (long long)bh * D * n + col;
  for (int e = 0; e < D; ++e) ob[(long long)e * n] = s[e] + cs[e].x;
"""),
]
B1_PARENT_SHAPES = [(b, 4, 32, n) for b in (8, 16) for n in (16384, 256)]


def strip(source: str, anchors, what: str) -> str:
    for kernel, start, end, body in anchors:
        a = source.find(start, source.find(kernel))
        if source.find(kernel) < 0 or a < 0 or source.find(end, a) < 0:
            sys.exit(f"{what} has no anchor {start!r} .. {end!r}")
        source = source[:a] + body + source[source.index(end, a):]
    return source


def forward_baseline(gen, parent: str, out_dir: str) -> list:
    """B.1 as it stood at 4c7182a: each of its three launches timed apart
    (``chip_smoke.call_launches``) at N = 16384 and 256, batch 8 and 16, the
    whole call, the copy with its arithmetic stripped, and ``torch.add``
    over q and k into out (the bytes of two of the call's four tensors)."""
    with open(os.path.join(parent, "tedm_tpu_torch", "kernels", "csrc", "linear_attention.cu")) as f:
        stripped = strip(f.read(), B1_PARENT_STRIP, "the parent's linear_attention.cu")
    libs = {"kernel": build_parent(parent, out_dir),
            "arithmetic stripped": build_parent(parent, out_dir, stripped, "la_parent_stripped")}
    scale = 32 ** -0.5
    rows = []
    for shape in B1_PARENT_SHAPES:
        q, k = (torch.randn(shape, generator=gen, device="cuda") * 2 for _ in range(2))
        v = torch.randn(shape, generator=gen, device="cuda") * shape[-1]
        ref = la.linear_attention_reference(q, k, v, scale)
        run = lambda: parent_forward(libs["kernel"])(q, k, v, scale)[0]
        err = (run() - ref).abs().max().item()
        if not err <= chip_smoke.LA_TOL:
            sys.exit(f"the parent's B.1 disagrees with the plain forward at {shape}: {err}")
        stripped = lambda: parent_forward(libs["arithmetic stripped"])(q, k, v, scale)
        out = torch.empty_like(q)
        row = {"shape": list(shape), "max_abs_err": err,
               "per_launch": chip_smoke.call_launches(f"parent B.1 {shape}", run, chip_smoke.REPS),
               "ms": chip_smoke.device_ms(run), "stripped_ms": chip_smoke.device_ms(stripped),
               "stripped_per_launch": chip_smoke.call_launches(f"parent B.1 stripped {shape}", stripped, chip_smoke.REPS),
               "add_ms": chip_smoke.device_ms(lambda: torch.add(q, k, out=out))}
        rows.append(row)
        split = lambda key: ", ".join(f"{chip_smoke.short_name(name)} {ms:.4f}" for name, ms in row[key])
        print(f"B.1 at 4c7182a {shape}: {row['ms']:.4f} ms ({split('per_launch')}); arithmetic stripped "
              f"{row['stripped_ms']:.4f} ms ({split('stripped_per_launch')}); torch.add(q, k) {row['add_ms']:.4f} ms",
              flush=True)
        del q, k, v, ref, out
    return rows


# B.1's routes: 0 the two launches, else la_cluster with that many CTAs a (b, h) (its CLUSTER)
B1_ROUTES = (0, 1, 2, 4, 8)
B1_CLUSTER = ("constexpr int CLUSTER = {};",)
# (slice width, warps a block, stages, blocks an SM) of the B.1 variants; the first is the source's
B1_VARIANTS = [(16, 8, 2, 2), (32, 8, 2, 1), (16, 16, 2, 1), (16, 4, 2, 4), (16, 4, 2, 3)]
B1_CONSTANTS = ("constexpr int FW = {};", "constexpr int FWARPS = {};", "constexpr int FSTAGES = {};",
                "constexpr int FWD_BLOCKS_PER_SM = {};")
# the forward's arithmetic replaced by a use of what it staged: the same loads and stores
B1_STRIP = [
    ("__device__ __forceinline__ void context_tiles(", "      float4* row = reinterpret_cast<float4*>(ks",
     "    __syncthreads();  // every warp is done with the tile",
     "      cx.l += ks[lane * TWP] + vs[lane * TWP];\n      cx.m = 0.f;\n    }\n"),
    ("__device__ __forceinline__ void apply_tiles(",
     "      {  // softmax over d of each column, in place: lane takes column lane % FW",
     "      store_slice<VEC>(qs, ob", ""),
]


def replace_constants(source: str, patterns, base, variant, what: str) -> str:
    for pattern, old, new in zip(patterns, base, variant):
        if pattern.format(old) not in source:
            sys.exit(f"{what} has no line {pattern.format(old)!r}")
        source = source.replace(pattern.format(old), pattern.format(new))
    return source


B1_ROUTE_HEAD = "int forward_route(int bh, int n) {"
B1_NAMESPACE_END = '}  // namespace\n\nextern "C" {\n'


def forced_route(source: str) -> str:
    """``source`` with ``la_force_route(route)``: from then on its
    la_forward_f32 and la_workspace_floats take ``route`` (0: the two
    launches; CLUSTER: la_cluster) in place of forward_route's, or
    forward_route's again for -1."""
    if source.count(B1_ROUTE_HEAD) != 1 or source.count(B1_NAMESPACE_END) != 1:
        sys.exit(f"linear_attention.cu has no single {B1_ROUTE_HEAD!r} or end of its namespace")
    source = source.replace(B1_ROUTE_HEAD, "int forced_route = -1;\nint source_route(int bh, int n) {")
    return source.replace(B1_NAMESPACE_END,
                          "int forward_route(int bh, int n) { return forced_route < 0 ? source_route(bh, n) : forced_route; }\n"
                          + B1_NAMESPACE_END + "void la_force_route(int route) { forced_route = route; }\n")


def forward_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Argument types of a forced-route copy's forward entry points."""
    lib.la_forward_f32.argtypes = la._library().la_forward_f32.argtypes
    lib.la_workspace_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.la_workspace_floats.restype = ctypes.c_longlong
    lib.la_force_route.argtypes = [ctypes.c_int]
    return lib


def forward_variants(out_dir: str) -> dict:
    """(variant, cluster size) -> a forced-route copy of the source with
    those constants (``B1_VARIANTS``, or the source with its arithmetic
    stripped; ``CLUSTER``), built in parallel."""
    with open(os.path.join(_build.CSRC, "linear_attention.cu")) as f:
        source = f.read()
    texts = {}
    for variant in B1_VARIANTS + ["arithmetic stripped"]:
        text = (strip(source, B1_STRIP, "linear_attention.cu") if variant == "arithmetic stripped"
                else replace_constants(source, B1_CONSTANTS, B1_VARIANTS[0], variant, "linear_attention.cu"))
        for cluster in B1_ROUTES[1:]:
            texts[variant, cluster] = forced_route(replace_constants(text, B1_CLUSTER, (2,), (cluster,),
                                                                     "linear_attention.cu"))
    name = lambda key: "la_fwd_" + "_".join(map(str, key[0] if isinstance(key[0], tuple) else ("stripped",))) \
        + f"_c{key[1]}"
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        libs = dict(zip(texts, pool.map(lambda key: build_variant(texts[key], name(key), out_dir), texts)))
    return {key: forward_library(lib) for key, lib in libs.items()}


def forward_call(lib, q, k, v, scale, route):
    """``la._forward``'s C call on a forced-route copy of the source, on
    ``route``."""
    b, h, d, n = q.shape
    out, ctx, stats = torch.empty_like(q), torch.empty(b * h, d, d, device=q.device), torch.empty(b * h, 2, d, device=q.device)
    lib.la_force_route(route)
    ws = torch.empty(lib.la_workspace_floats(b * h, n), device=q.device)
    arrivals = torch.zeros(b * h, device=q.device, dtype=torch.int32)

    def run():
        lib.la_force_route(route)
        err = lib.la_forward_f32(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), ctx.data_ptr(),
                                 stats.data_ptr(), ws.data_ptr(), arrivals.data_ptr(), q.stride(0), k.stride(0),
                                 v.stride(0), b, h, n, scale, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forward variant launch failed with CUDA error {err}")
        return out, ctx, stats
    return run


ROUTE = "route"


def forward_designs(gen, out_dir: str) -> list:
    """B.1 by route (``B1_ROUTES``) and build (``B1_VARIANTS``, and the
    source with its arithmetic stripped) at the 8 path shapes, a serving
    request's (batch 8) and a training step's (batch 16): each held against
    the plain forward (out within ``chip_smoke.LA_TOL``, the saved scale*C,
    m and l within it relative) at the shape and at
    ``chip_smoke.edge_inputs``, the stripped build excepted, then timed
    (``chip_smoke.device_ms``); each launch of the source's two-launch
    route and of the route it takes timed apart at N = 16384 and 256."""
    libs = forward_variants(out_dir)
    scale = 32 ** -0.5
    stripped = "arithmetic stripped"
    # each build's two launches on its copy with CLUSTER = 2, its cluster route on the copy of that size
    runs = lambda q, k, v: {(key, route): forward_call(libs[key, route or 2], q, k, v, scale, route)
                            for key in B1_VARIANTS + [stripped] for route in B1_ROUTES}

    def errors(run, q, k, v):
        out, ctx, stats = run()
        ref, saved = la.linear_attention_reference(q, k, v, scale), la.linear_attention_saved_reference(q, k, v, scale)
        return [(out - ref).abs().max().item(), chip_smoke.rel_err(ctx, saved[0]), chip_smoke.rel_err(stats, saved[1])]

    label = lambda r: "two launches" if r == 0 else f"cluster {r}"
    for what, q, k, v in chip_smoke.edge_inputs(gen):
        for (key, route), run in runs(q, k, v).items():
            if key != stripped:
                errs = errors(run, q, k, v)
                if not max(errs) <= chip_smoke.LA_TOL:
                    sys.exit(f"B.1 {key} {label(route)} disagrees with the plain forward at {what}: {errs}")
    rows = []
    for shape in chip_smoke.SERVE_SHAPES + chip_smoke.TRAIN_SHAPES:
        b, h, d, n = shape
        q, k = (torch.randn(shape, generator=gen, device="cuda") * 2 for _ in range(2))
        v = torch.randn(shape, generator=gen, device="cuda") * n
        row = {"shape": list(shape), "route": la.forward_route(b * h, n), "ms": {}, "max_err": {}, "per_launch": {}}
        shape_runs = runs(q, k, v)
        for (key, route), run in shape_runs.items():
            name = f"{key} {label(route)}"
            if key != stripped:
                row["max_err"][name] = errs = errors(run, q, k, v)
                if not max(errs) <= chip_smoke.LA_TOL:
                    sys.exit(f"B.1 {name} disagrees with the plain forward at {shape}: {errs}")
            row["ms"][name] = chip_smoke.device_ms(run)
        if n in (256, 16384):
            for route in dict.fromkeys((0, row["route"])):
                row["per_launch"][label(route)] = chip_smoke.call_launches(
                    f"B.1 {shape} {label(route)}", shape_runs[B1_VARIANTS[0], route], chip_smoke.REPS)
        rows.append(row)
        best = min(row["ms"], key=lambda key: row["ms"][key] if stripped not in key else float("inf"))
        print(f"B.1 {shape}: the source's route {label(row['route'])}: "
              f"{row['ms'][f'{B1_VARIANTS[0]} {label(row[ROUTE])}'] * 1e3:.1f} us; "
              f"fastest {best} {row['ms'][best] * 1e3:.1f} us", flush=True)
        for key in B1_VARIANTS + [stripped]:
            print(f"  {key}: " + ", ".join(f"{label(r)} {row['ms'][f'{key} {label(r)}'] * 1e3:.1f}" for r in B1_ROUTES),
                  flush=True)
        for r, pl in row["per_launch"].items():
            print(f"  launches, {r}: " + ", ".join(f"{chip_smoke.short_name(nm)} {ms * 1e3:.1f}" for nm, ms in pl),
                  flush=True)
        del q, k, v, shape_runs
    return rows


# globaltimer stamps in a copy of la_cluster: (text the stamp goes before, the phase it opens)
B1_STAMPS = [("  Context cx;\n", "k and v tiles"),
             ("  store_context(cx, smem + warp * PART, lane);", "warp merge, first q tile issued"),
             ("  cluster_arrive();  // this CTA's partial is written ...\n", "cluster barrier"),
             ("  merge_parts<false>(CLUSTER,", "merge through distributed shared memory"),
             ("  cluster_arrive();  // done reading", "scale*C, its A operands"),
             ("  apply_tiles<VEC>(smem, qb, out", "apply"),
             ("  cluster_wait();  // no CTA leaves", "final cluster wait")]
B1_PHASE_SHAPES = [(8, 4, 32, 256), (16, 4, 32, 256), (8, 4, 32, 1024), (16, 4, 32, 16384)]


def stamped_cluster(source: str) -> str:
    """``source`` with a globaltimer stamp, by thread 0 of each CTA, before
    each anchor of ``B1_STAMPS`` in la_cluster and at its end, kept in a
    device array that ``la_stamps`` copies out."""
    stamp = ("  if (threadIdx.x == 0) {{ unsigned long long tt; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(tt)); "
             "g_stamps[((long long)blockIdx.y * gridDim.x + blockIdx.x) * 8 + {}] = tt; }}\n")
    at = source.index("la_cluster(const float* __restrict__ q")
    head, body = source[:at], source[at:]
    pos = 0
    for i, (anchor, _) in enumerate(B1_STAMPS + [("}\n", "end")]):
        j = body.find(anchor, pos)
        if j < 0:
            sys.exit(f"la_cluster has no anchor {anchor!r}")
        body = body[:j] + stamp.format(i) + body[j:]
        pos = j + len(stamp.format(i)) + (0 if i == len(B1_STAMPS) else len(anchor))
    text = head.replace("namespace {\n", "namespace {\n__device__ unsigned long long g_stamps[8192 * 8];\n", 1) + body
    return text + '\nextern "C" int la_stamps(void* dst, int n) { return (int)cudaMemcpyFromSymbol(dst, g_stamps, n * 8); }\n'


def cluster_phases(gen, out_dir: str) -> list:
    """Where a la_cluster launch spends its time: per phase (``B1_STAMPS``),
    the median over CTAs of the globaltimer between its stamps, in one launch
    after warm-up, at ``B1_PHASE_SHAPES``, each on the cluster route."""
    with open(os.path.join(_build.CSRC, "linear_attention.cu")) as f:
        lib = forward_library(build_variant(forced_route(stamped_cluster(f.read())), "la_stamped", out_dir))
    route = la.forward_route(1, 1)  # the source's CLUSTER: N = 1 takes the cluster route
    rows = []
    for shape in B1_PHASE_SHAPES:
        q, k = (torch.randn(shape, generator=gen, device="cuda") * 2 for _ in range(2))
        v = torch.randn(shape, generator=gen, device="cuda") * shape[-1]
        run = forward_call(lib, q, k, v, 32 ** -0.5, route)
        for _ in range(5):
            run()
        torch.cuda._sleep(2_000_000)
        run()
        torch.cuda.synchronize()
        ctas = shape[0] * shape[1] * route
        buf = (ctypes.c_ulonglong * (ctas * 8))()
        lib.la_stamps(buf, ctas * 8)
        st = [buf[c * 8:c * 8 + 8] for c in range(ctas)]
        t0 = min(s[0] for s in st)
        row = {"shape": list(shape), "cluster": route, "start_spread_us": (max(s[0] for s in st) - t0) / 1e3,
               "end_us": (max(s[7] for s in st) - t0) / 1e3,
               "median_us": {name: statistics.median((s[i + 1] - s[i]) / 1e3 for s in st)
                             for i, (_, name) in enumerate(B1_STAMPS)}}
        rows.append(row)
        print(f"la_cluster {shape} cluster {route}: last CTA ends {row['end_us']:.2f} us after the first starts; "
              + ", ".join(f"{name} {us:.2f}" for name, us in row["median_us"].items()), flush=True)
        del q, k, v
    return rows


SECTIONS = ("groupnorm", "b1_parent", "b1", "b1_phases", "b1b")
DEFAULT_SECTIONS = [s for s in SECTIONS if s != "b1_parent"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of commit 4c7182a, for B.1's earlier design")
    ap.add_argument("--sections", nargs="+", choices=SECTIONS, default=DEFAULT_SECTIONS)
    args = ap.parse_args()
    if "b1_parent" in args.sections and not args.parent:
        ap.error("the b1_parent section needs --parent")
    if not torch.cuda.is_available():
        sys.exit("no card: this script times kernels on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    result = {"device": smi}
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        if "groupnorm" in args.sections:
            result["groupnorm"] = groupnorm_sweep(gen)
        if "b1_parent" in args.sections:
            result["linear_attention_parent"] = forward_baseline(gen, args.parent, tmp)
        if "b1" in args.sections:
            result["linear_attention"] = forward_designs(gen, tmp)
        if "b1_phases" in args.sections:
            result["linear_attention_phases"] = cluster_phases(gen, tmp)
        if "b1b" in args.sections:
            result["linear_attention_backward"] = backward_sweep(gen, tmp)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
