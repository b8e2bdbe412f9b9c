"""The r5 quality chain in the port: Dice of the port's TEDM, supervised
baseline and PDDM probe on the hard synthetic corpus, beside the values the
JAX package and the torch reference recorded for the same protocol
(``docs/parity_artifacts/r5/seed_table.json``, ``RESULTS_parity.md`` r5).

Chain (the JAX package's ``scripts/parity/run_tpu.py``, through the port's
own entry points): write the hard corpus with ``export_corpus.py``; train
an ``img_only`` backbone at seed 0 (``--backbone_seed``); train heads on it
at each n of ``--sizes`` and each seed of ``--seeds`` (``Step_<t>``, the PDDM probe at
timestep t, at the first seed only, as r5 ran it); evaluate each head with
``tedm_tpu_torch.eval.run_tests`` (``testing_shared_weights`` for TEDM)
over JSRT_val, JSRT_test, NIH and Montgomery. The contrastive arm
(``--experiments ... global_finetune glob_loc_finetune``): ``global_cl``
for ``--cl_steps`` steps on the corpus's CXR14 files, ``local_cl`` as long
from it, then the two finetunes from them at each n and seed, as the
heads (the JAX package has no value on this protocol: these cells have no
band). Writes
``<out>/s<seed>/summary.json`` in ``run_tpu.py``'s schema and
``<out>/quality.json``: per cell and set the port's Dice x100 by seed, the
r5 values, and on JSRT_test whether the mean of the port's seeds lies in
the r5 band (the span of the r5 tedm_tpu and torch values widened by 1.0;
a cell with one r5 value, that value +-1.5). A backbone already in
``<out>`` is reused (and said so), or ``--backbone_dir`` names one (the JAX
package's, carried over by ``scripts/jax_backbone_to_port.py``); the heads
are always trained and evaluated anew.

    python scripts/port/quality_r5.py --root DIR/corpus --out DIR/runs
    # with the contrastive arm:
    python scripts/port/quality_r5.py --root DIR/corpus --out DIR/runs --seeds 0 \\
        --experiments baseline global_finetune glob_loc_finetune
    # a tiny run of the logic on the CPU:
    python scripts/port/quality_r5.py --root R --out O --img_size 16 --n_cxr 8 \\
        --backbone_steps 2 --head_steps 2 --sizes 1 --seeds 0 --device cpu \\
        --extra --dim 8 --dim_mults 1 2 --timesteps 20
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SETS = ("JSRT_val", "JSRT_test", "NIH", "Montgomery")
R5_TABLE = os.path.join(REPO, "docs", "parity_artifacts", "r5", "seed_table.json")


def summarize(outputs: Dict[str, Dict[str, np.ndarray]]) -> dict:
    """run_tpu.py's per-set summary of the eval outputs."""
    res = {}
    for key, out in outputs.items():
        d = np.asarray(out["dice"]).squeeze()
        res[key] = {
            "dice_mean": float(np.nanmean(d)),
            "dice_std": float(np.nanstd(d[~np.isnan(d)])),
            "precision_mean": float(np.nanmean(np.asarray(out["precision"]))),
            "recall_mean": float(np.nanmean(np.asarray(out["recall"]))),
            "n": int(d.shape[0]),
        }
    return res


def per_timestep(exp_dir: str, key: str) -> dict:
    """Dice of each timestep's npz of a TEDM head (run_tpu.py's block)."""
    out = {}
    for f in glob.glob(os.path.join(exp_dir, f"{key}_timestep*_predictions.npz")):
        d = np.asarray(np.load(f)["dice"]).squeeze()
        out[f.rsplit("timestep", 1)[1].split("_")[0]] = {
            "dice_mean": float(np.nanmean(d)), "dice_std": float(np.nanstd(d[~np.isnan(d)]))}
    return out


def r5_band(values: Sequence[float]) -> tuple:
    lo, hi = min(values), max(values)
    widen = 1.0 if len(values) > 1 else 1.5
    return lo - widen, hi + widen


def compare(summaries: Dict[int, dict]) -> dict:
    """{cell|set: {port: [Dice x100 by seed], port_mean, r5 values, and on
    JSRT_test the band and whether the port's mean lies in it}}."""
    r5 = {}
    if os.path.exists(R5_TABLE):
        with open(R5_TABLE) as f:
            r5 = json.load(f)
    table = {}
    cells = sorted({c for s in summaries.values() for c in s["experiments"]})
    for cell in cells:
        for ds in SETS:
            port = [100.0 * s["experiments"][cell][ds]["dice_mean"]
                    for _, s in sorted(summaries.items()) if cell in s["experiments"]]
            ref = r5.get(f"{cell}|{ds}", {"tedm_tpu": [], "torch": []})
            row = {"port": port, "port_mean": float(np.mean(port)), "r5_tedm_tpu": ref["tedm_tpu"],
                   "r5_torch": ref["torch"]}
            values = ref["tedm_tpu"] + ref["torch"]
            if ds == "JSRT_test" and values:
                lo, hi = r5_band(values)
                row.update(band=[lo, hi], in_band=bool(lo <= row["port_mean"] <= hi))
            table[f"{cell}|{ds}"] = row
    return table


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, required=True, help="the corpus (written here if absent)")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--img_size", type=int, default=64)
    ap.add_argument("--n_cxr", type=int, default=512)
    ap.add_argument("--backbone_steps", type=int, default=400)
    ap.add_argument("--head_steps", type=int, default=300)
    ap.add_argument("--sizes", nargs="+", type=int, default=[1, 3])
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--backbone_dir", type=str, default=None,
                    help="the heads' backbone: this checkpoint directory instead of one trained here (e.g. the JAX "
                         "package's, carried over by scripts/jax_backbone_to_port.py)")
    ap.add_argument("--backbone_seed", type=int, default=0,
                    help="the backbone's seed (r5: 0); another shows how much the heads move with the backbone")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--experiments", nargs="+", default=["baseline", "TEDM", "Step_1"],
                    help="baseline, LEDM, LEDMe, TEDM, Step_<t> (PDDM at timestep t), global_finetune, "
                         "glob_loc_finetune")
    ap.add_argument("--cl_steps", type=int, default=300, help="steps of global_cl and of local_cl")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="arguments appended to every training command")
    args = ap.parse_args(argv)

    import torch

    import export_corpus
    from tedm_tpu_torch.eval import run_tests, testing_shared_weights
    from tedm_tpu_torch.eval.harness import load_output
    from tedm_tpu_torch.train import main as train_main
    from tedm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    device_name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {device_name}; {card()}", flush=True)
    if not os.path.exists(os.path.join(args.root, "data", "JSRT_train_split.csv")):
        t0 = time.perf_counter()
        export_corpus.main(["--root", args.root, "--img_size", str(args.img_size), "--hard",
                            "--n_cxr", str(args.n_cxr)])
        print(f"corpus written in {time.perf_counter() - t0:.1f} s", flush=True)
    common = ["--data_dir", "", "--splits_dir", os.path.join(args.root, "data"), "--img_size", str(args.img_size),
              "--batch_size", str(args.batch_size), "--num_workers", "2"] + list(args.extra)
    with_data = lambda corpus: [a if a else os.path.join(args.root, corpus) for a in common]
    nih, mon = os.path.join(args.root, "NIH"), os.path.join(args.root, "Montgomery")

    backbone = args.backbone_dir or os.path.join(args.out, "CXR14", "run", "best")
    timing = {}
    if not set(args.experiments) - {"baseline", "global_finetune", "glob_loc_finetune"}:
        print("=== backbone: not needed ===", flush=True)
    elif args.backbone_dir:
        print(f"=== backbone: {backbone} (given) ===", flush=True)
    elif os.path.isdir(backbone):
        print(f"=== backbone: reusing {backbone} ===", flush=True)
    else:
        print("=== backbone (img_only) ===", flush=True)
        t0 = time.perf_counter()
        train_main(["--experiment", "img_only", "--log_dir", os.path.join(args.out, "run"),
                    "--max_steps", str(args.backbone_steps), "--log_freq", "100",
                    "--val_freq", str(max(args.backbone_steps // 2, 1)), "--max_val_steps", "4",
                    "--n_sampled_imgs", "2", "--seed", str(args.backbone_seed)] + with_data("CXR14"), device=dev)
        timing["backbone"] = {"train_s": time.perf_counter() - t0}

    # the contrastive pretraining the finetunes start from, at the backbone's seed
    pretrained = {}
    if {"global_finetune", "glob_loc_finetune"} & set(args.experiments):
        for exp, warm in (("global_cl", []), ("local_cl", ["--global_model_path", "global_cl"])):
            found = glob.glob(os.path.join(args.out, exp, "*", "run", "best"))
            if found:
                print(f"=== {exp}: reusing {found[0]} ===", flush=True)
            else:
                print(f"=== {exp} ===", flush=True)
                t0 = time.perf_counter()
                train_main(["--experiment", exp, "--log_dir", os.path.join(args.out, "run"),
                            "--max_steps", str(args.cl_steps), "--log_freq", "100",
                            "--val_freq", str(max(args.cl_steps // 2, 1)), "--max_val_steps", "4",
                            "--seed", str(args.backbone_seed)] + [pretrained.get(a, a) for a in warm]
                           + with_data("CXR14"), device=dev)
                timing[exp] = {"train_s": time.perf_counter() - t0}
                found = glob.glob(os.path.join(args.out, exp, "*", "run", "best"))
            pretrained[exp] = found[0]
    warm_start = {"global_finetune": ["--global_model_path", "global_cl"],
                  "glob_loc_finetune": ["--glob_loc_model_path", "local_cl"]}

    summaries = {}
    for seed in args.seeds:
        out = os.path.join(args.out, f"s{seed}")
        summary = {"img_size": args.img_size, "backbone_steps": args.backbone_steps,
                   "head_steps": args.head_steps, "framework": "tedm_tpu_torch", "device": device_name,
                   "seed": seed, "backbone_seed": args.backbone_seed, "backbone_dir": args.backbone_dir, "extract_unnormalized": False, "ema_decay": 0.0, "serve_raw_params": False,
                   "experiments": {}, "timing": timing if seed == args.seeds[0] else {}}
        for exp in args.experiments:
            step_t = int(exp.split("_", 1)[1]) if exp.startswith("Step_") else None
            if step_t is not None and seed != args.seeds[0]:
                continue
            cli_exp = "PDDM" if step_t is not None else exp
            tag = {"baseline": "b", "LEDM": "l", "LEDMe": "e", "TEDM": "t", "global_finetune": "g",
                   "glob_loc_finetune": "gl"}.get(cli_exp, f"s{step_t}n")
            for n in args.sizes:
                print(f"=== {exp} n={n} seed={seed} ===", flush=True)
                cmd = ["--experiment", cli_exp, "--n_labelled_images", str(n), "--seed", str(seed),
                       "--log_dir", os.path.join(out, f"{tag}{n}"), "--max_steps", str(args.head_steps),
                       "--log_freq", "50", "--val_freq", str(min(50, args.head_steps))]
                if cli_exp in warm_start:
                    cmd += [pretrained.get(a, a) for a in warm_start[cli_exp]]
                elif cli_exp != "baseline":
                    cmd += ["--saved_diffusion_model", backbone]
                if step_t is not None:
                    cmd += ["--t_steps_to_save", str(step_t)]
                t0 = time.perf_counter()
                train_main(cmd + with_data("JSRT"), device=dev)
                t1 = time.perf_counter()
                exp_dir = os.path.join(out, cli_exp, str(n), f"{tag}{n}")
                cli = testing_shared_weights if exp == "TEDM" else run_tests
                cli.main(["--experiment", exp_dir, "--nih_path", nih, "--mon_path", mon, "--rerun"], device=dev)
                t2 = time.perf_counter()
                summ = summarize({k: load_output(os.path.join(exp_dir, f"{k}_predictions.npz")) for k in SETS})
                if exp == "TEDM":
                    for key in summ:
                        summ[key]["per_timestep"] = per_timestep(exp_dir, key)
                summary["experiments"][f"{exp}/{n}"] = dict(summ, mechanism={
                    "extract_unnormalized": False, "ema_decay": 0.0, "serve_raw_params": False})
                summary["timing"][f"{exp}/{n}"] = {"train_s": t1 - t0, "eval_s": t2 - t1,
                                                    "eval_images": sum(s["n"] for s in summ.values())}
                os.makedirs(out, exist_ok=True)
                with open(os.path.join(out, "summary.json"), "w") as f:
                    json.dump(summary, f, indent=2)
        summaries[seed] = summary

    table = compare(summaries)
    with open(os.path.join(args.out, "quality.json"), "w") as f:
        json.dump({"device": device_name, "card": card(), "cells": table}, f, indent=2)
    print(f"{'cell|set':<24} {'port Dice x100 by seed':<30} {'mean':>7}  r5 band (JSRT_test)")
    for key, row in table.items():
        band = f"[{row['band'][0]:.2f}, {row['band'][1]:.2f}] {'in' if row['in_band'] else 'MISS'}" if "band" in row else ""
        print(f"{key:<24} {' '.join(f'{v:.2f}' for v in row['port']):<30} {row['port_mean']:7.2f}  {band}")
    print(f"wrote {os.path.join(args.out, 'quality.json')}")


if __name__ == "__main__":
    main()
