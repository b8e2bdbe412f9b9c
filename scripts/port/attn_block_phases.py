#!/usr/bin/env python3
"""Where a block of the fused PreNorm linear-attention kernel (B.2) spends its cycles, on one card.

    python3 scripts/port/attn_block_phases.py [--emit FILE]

Writes a copy of ``tedm_tpu_torch/kernels/csrc/attn_block.cu`` with
``clock64()`` stamps at the end of each phase of ``kv_context`` (pass 1) and
``apply_block`` (pass 2), builds it with the flags of ``kernels/_build.py``,
runs it in place of the package's kernel at four of the UNet's call shapes
(10 calls after 3 warm-up ones, inputs of ``chip_smoke.block_inputs``) and
prints, per pass, the cycles one block (blockIdx (3, 1)) spent in each
phase, summed over its tiles, a call. Before each stamp the phase's last
products are awaited, so that a phase's products count in it. The stamps
cost some cycles of their own; the kernel's time beside them is
``chip_smoke.device_ms`` of the stamped kernel. ``--emit FILE`` only writes
the stamped source (no card needed), to check that every anchor is found.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from tedm_tpu_torch.kernels import _build  # noqa: E402

HEADER = """
__device__ unsigned long long g_phase[2][16];
#define PH_BEGIN(k) long long ph_t = clock64(); \\
  const bool ph_on = blockIdx.x == 3 && blockIdx.y == 1 && threadIdx.x == 0; const int ph_k = k;
#define PH(i) do { long long ph_n = clock64(); \\
  if (ph_on) atomicAdd(&g_phase[ph_k][i], (unsigned long long)(ph_n - ph_t)); ph_t = ph_n; } while (0)
#define AWAIT(v) asm volatile("" :: "f"(v) : "memory")
"""

# (anchor, stamp inserted after it): kv_context's, then apply_block's
STAMPS = [
    ("  const bf16* xb = x + b * x_bstride;\n", "  PH_BEGIN(0)\n"),
    ("    __syncthreads();  // this tile is in; the previous tile's ks, vs, fac and other stage are consumed\n",
     "    PH(0);\n"),
    ("    column_stats<T>(ys, c, mean, rstd, red);\n", "    PH(1);\n"),
    ("    normalize<T>(ys, ys, c, mean, rstd, gin);\n", "    PH(2);\n"),
    ("      gemm<1, NT, T>(acc, wkv, kt, 8 * kv + warp, ys, lane);\n",
     "      AWAIT(acc[0][NT - 1][3]); PH(3 + 2 * kv);\n"),
    ("        *reinterpret_cast<uint32_t*>(p + 8 * KS) = pack2(acc[0][nt][2], acc[0][nt][3]);\n      }\n",
     "      PH(4 + 2 * kv);\n"),
    ("        mma(ctx[nt], a, b0, b1);\n      }\n    }\n", "    AWAIT(ctx[3][3]); PH(7);\n"),
    ("  if (!last) return;\n", "  PH(8);\n"),
    ("      cb[(row / DH) * DH * DH + frag_index32(e + k, row % DH)] = __float2bfloat16(vals[k] / denom[row]);\n  }\n",
     "  PH(9);\n"),
    ("  cp_async_commit();\n  cp_async_wait_all();\n  __syncthreads();\n", "  PH(0);\n"),
    ("  column_stats<T>(xs, c, mean, rstd, red);\n", "  PH(1);\n"),
    ("  normalize<T>(xs, ys, c, mean, rstd, g_in);\n", "  PH(2);\n"),
    ("    gemm<1, NT, T>(acc, wqkv, c / 16, warp, ys, lane);\n", "    AWAIT(acc[0][NT - 1][3]); PH(3);\n"),
    ("        for (int e = 0; e < 2; ++e) qmax[warp * T + 8 * nt + 2 * t4 + e] = cm[nt][e];\n    __syncthreads();\n",
     "    PH(4);\n"),
    ("      *reinterpret_cast<uint32_t*>(p + 8 * P) = pack2(q[2], q[3]);\n    }\n  }\n  __syncthreads();\n",
     "  PH(5);\n"),
    ("      *reinterpret_cast<uint32_t*>(p + 8 * P) = pack2(acc[0][nt][2], acc[0][nt][3]);\n    }\n  }\n  __syncthreads();\n",
     "  PH(6);\n"),
    ("          pp[1] = s2[nt][e];\n        }\n  }\n  __syncthreads();\n", "  PH(7);\n"),
    ("    rstd[tid] = rsqrtf(fmaxf(q / (float)c - mu * mu, 0.f) + 1e-5f);\n  }\n  __syncthreads();\n",
     "  PH(8);\n"),
    ("                (o[i][0][nt][3] - mean[col + 1]) * rstd[col + 1] * gr1 + __high2float(x1));\n    }\n  }\n"
     "  __syncthreads();\n", "  PH(9);\n"),
]
# the phases, by the index of the stamp that ends each
NAMES = (
    ["wait for the tile's x", "LayerNorm statistics", "normalize", "k product", "k softmax and stores",
     "v product", "v stores", "sync and context products", "partials out, arrival", "combine (last block only)"],
    ["x", "LayerNorm statistics", "normalize", "q product", "q's column max, per warp", "q softmax over d",
     "attention product", "W_out product, its column sums", "output LayerNorm statistics",
     "normalize, residual, staging"],
)
APPLY_BEGIN = ("  load_tile<T>(xs, x + b * x_bstride, c, n, n0, vec);\n", "  PH_BEGIN(1)\n")


def stamped_source() -> str:
    src = open(os.path.join(_build.CSRC, "attn_block.cu")).read()
    src = src.replace('#include "tensor_core.cuh"\n', '#include "tensor_core.cuh"\n' + HEADER, 1)
    anchor, stamp = APPLY_BEGIN
    if anchor not in src:
        sys.exit(f"anchor not found in attn_block.cu: {anchor!r}")
    src = src.replace(anchor, stamp + anchor, 1)
    for anchor, stamp in STAMPS:
        if anchor not in src:
            sys.exit(f"anchor not found in attn_block.cu: {anchor!r}")
        if stamp:
            src = src.replace(anchor, anchor + stamp, 1)
    return src.replace('extern "C" {\n', """extern "C" {
int pla_phases(unsigned long long* out) { return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)); }
int pla_phases_reset() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z));
}
""", 1)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--emit", help="write the stamped source here and stop")
    args = ap.parse_args()
    src = stamped_source()
    if args.emit:
        with open(args.emit, "w") as f:
            f.write(src)
        return
    import torch
    import chip_smoke
    from tedm_tpu_torch.kernels import attn_block

    if not torch.cuda.is_available():
        sys.exit("no card: this script times a kernel on a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "attn_block_phases.cu"), os.path.join(tmp, "attn_block_phases.so")
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", so, cu], check=True)
        lib = ctypes.CDLL(so)
        lib.pla_workspace_floats.argtypes = [ctypes.c_int] * 3
        lib.pla_workspace_floats.restype = ctypes.c_longlong
        lib.pla_forward_bf16.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p]
        attn_block._library = lambda: lib
        gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
        with torch.no_grad():
            for shape in [(8, 64, 16384), (8, 64, 4096), (8, 128, 4096), (8, 512, 256)]:
                inputs = chip_smoke.block_inputs(gen, *shape)
                for _ in range(3):
                    attn_block.prenorm_linear_attention(*inputs)
                torch.cuda.synchronize()
                lib.pla_phases_reset()
                for _ in range(10):
                    attn_block.prenorm_linear_attention(*inputs)
                torch.cuda.synchronize()
                buf = (ctypes.c_ulonglong * 32)()
                lib.pla_phases(buf)
                ms = chip_smoke.device_ms(lambda: attn_block.prenorm_linear_attention(*inputs))
                print(f"{shape}: stamped kernel {ms:.4f} ms; cycles a call of block (3, 1):", flush=True)
                for k, label in enumerate(("kv_context", "apply_block")):
                    row = ", ".join(f"{name} {buf[16 * k + i] / 10:.0f}" for i, name in enumerate(NAMES[k]))
                    print(f"  {label}: {row}", flush=True)


if __name__ == "__main__":
    main()
