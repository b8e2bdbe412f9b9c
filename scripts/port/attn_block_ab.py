#!/usr/bin/env python3
"""The fused PreNorm linear-attention kernel (B.2) against an earlier commit's, on one card.

    python3 scripts/port/attn_block_ab.py --parent DIR

DIR holds a checkout of the earlier commit (``git archive <commit> | tar -x
-C DIR``). Both commits' ``tedm_tpu_torch/kernels/csrc/attn_block.cu`` are
built with the flags of ``kernels/_build.py``. At each of the default
UNet's B.2 call shapes (batch 8, a serving request's; batch 16, a training
step's) both kernels are held against the plain version on the same inputs
(``chip_smoke.block_inputs``, within ``chip_smoke.BLOCK_TOL``), then timed in
turns, parent, this, this, parent (``chip_smoke.device_ms``: median device
time of 25 calls, CUDA events). The earlier kernel takes the weights in
fp32, as the earlier interface did; this one its cached bf16 fragment layouts,
which a served model builds once. Prints a row a shape, the sums over a
request's and a step's 8 calls, and one JSON line.
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
from tedm_tpu_torch.kernels import _build, attn_block  # noqa: E402


def load_parent(parent: str, out_dir: str) -> ctypes.CDLL:
    csrc = os.path.join(parent, "tedm_tpu_torch", "kernels", "csrc")
    lib_path = os.path.join(out_dir, "attn_block_parent.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib_path, os.path.join(csrc, "attn_block.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    lib.pla_workspace_floats.argtypes = [ctypes.c_int] * 3
    lib.pla_workspace_floats.restype = ctypes.c_longlong
    lib.pla_forward_bf16.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.pla_forward_bf16.restype = ctypes.c_int
    return lib


def parent_call(lib, x, g_in, w_qkv, w_out, b_out, g_out):
    """The earlier kernel's call: fp32 contiguous weights, as its wrapper passed them."""
    b, c, n = x.shape
    ws = [t.detach().float().contiguous() for t in (g_in, w_qkv, w_out, b_out, g_out)]
    out = torch.empty_like(x)
    scratch = torch.empty(lib.pla_workspace_floats(b, c, n), device=x.device, dtype=torch.float32)

    def run():
        err = lib.pla_forward_bf16(x.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(), scratch.data_ptr(),
                                   x.stride(0), b, c, n, attn_block.SCALE, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kernel launch failed with CUDA error {err}")
        return out
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="a checkout of the earlier commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no card: this script times kernels on a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    rows = []
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        lib = load_parent(args.parent, tmp)
        for shape in dict.fromkeys(chip_smoke.block_shapes(8) + chip_smoke.block_shapes(16)):
            inputs = chip_smoke.block_inputs(gen, *shape)
            ref = attn_block.prenorm_linear_attention_reference(*inputs).float()
            parent = parent_call(lib, *inputs)
            this = lambda: attn_block.prenorm_linear_attention(*inputs)
            errs = [(fn().float() - ref).abs().max().item() for fn in (parent, this)]
            if max(errs) > chip_smoke.BLOCK_TOL:
                sys.exit(f"a kernel disagrees with the plain version at {shape}: {errs}")
            p1, t1, t2, p2 = (chip_smoke.device_ms(fn) for fn in (parent, this, this, parent))
            row = {"shape": list(shape), "parent_ms": [p1, p2], "ms": [t1, t2], "max_abs_err": errs}
            rows.append(row)
            print(f"{shape}: parent {p1:.4f} {p2:.4f} ms, this {t1:.4f} {t2:.4f} ms, "
                  f"{(p1 + p2) / (t1 + t2):.2f}x; errors {errs[0]:.3e}, {errs[1]:.3e}", flush=True)
    by = {tuple(r["shape"]): r for r in rows}
    for label, batch in (("a request's 8 calls (batch 8)", 8), ("a step's 8 calls (batch 16)", 16)):
        calls = chip_smoke.block_shapes(batch)
        parent = sum(sum(by[s]["parent_ms"]) / 2 for s in calls)
        this = sum(sum(by[s]["ms"]) / 2 for s in calls)
        print(f"{label}: parent {parent:.4f} ms, this {this:.4f} ms", flush=True)
    print(json.dumps({"device": smi, "rows": rows}))


if __name__ == "__main__":
    main()
