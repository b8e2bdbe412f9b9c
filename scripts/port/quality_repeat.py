"""Does the r5 chain repeat on one tree, and if not, where does it part?

Given a finished ``quality_r5.py`` run (``--first``), it runs one cell of
the chain again through ``quality_r5.main`` (TEDM at n = 1, the cell that
left its band, at every seed of ``--seeds``): once on a copy of the first run's backbone
(``<first>_same``: do the heads repeat?) and once with a backbone trained
anew at the same seed (``<first>_new``: does the backbone repeat?). It then
compares the two backbones tensor by tensor and the cell's JSRT_test Dice
seed by seed across the three runs.

To find where two runs part, it trains ``--check_steps`` backbone steps and
head steps twice in each of three modes and compares the weights: torch's
defaults (as the chain runs), ``torch.backends.cudnn.deterministic``, and
``torch.use_deterministic_algorithms(True, warn_only=True)``, recording the
ops that the last mode warns of as nondeterministic. Writes
``<first>_repeat.json``.

    python scripts/port/quality_r5.py --root DIR/corpus --out DIR/runs
    python scripts/port/quality_repeat.py --root DIR/corpus --first DIR/runs
    # on the CPU, after quality_r5.py's tiny run (its module docstring):
    python scripts/port/quality_repeat.py --root R --first O --img_size 16 --seeds 0 \\
        --backbone_steps 2 --head_steps 2 --check_steps 2 --device cpu \\
        --extra --dim 8 --dim_mults 1 2 --timesteps 20
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import warnings
from typing import Dict, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import quality_r5  # noqa: E402

MODES = ("default", "cudnn_deterministic", "deterministic_algorithms")
EXPERIMENT, SIZE = "TEDM", 1


def flat_tensors(state, prefix: str = "") -> Dict[str, np.ndarray]:
    """The tensors of a checkpoint's nested state, by dotted path."""
    import torch

    out = {}
    if isinstance(state, dict):
        for k, v in state.items():
            out.update(flat_tensors(v, f"{prefix}{k}."))
    elif isinstance(state, (list, tuple)):
        for i, v in enumerate(state):
            out.update(flat_tensors(v, f"{prefix}{i}."))
    elif isinstance(state, torch.Tensor):
        out[prefix[:-1]] = state.detach().cpu().double().numpy()
    return out


def compare_states(a: str, b: str) -> dict:
    """Max abs difference of two checkpoints' tensors, and how many differ."""
    from tedm_tpu_torch.utils.checkpoint import load_checkpoint

    ta, tb = (flat_tensors(load_checkpoint(p, verbose=False)[0]) for p in (a, b))
    assert ta.keys() == tb.keys(), sorted(set(ta) ^ set(tb))
    diffs = {k: float(np.abs(ta[k] - tb[k]).max()) if ta[k].size else 0.0 for k in ta}
    worst = max(diffs, key=diffs.get)
    return {"tensors": len(diffs), "differ": sum(d > 0 for d in diffs.values()),
            "max_abs_diff": diffs[worst], "worst": worst,
            "finite": all(np.isfinite(t[k]).all() for t in (ta, tb) for k in t)}


def cell_dice(out: str, cell: str, seeds: Sequence[int]) -> list:
    """The cell's JSRT_test Dice x100 by seed from ``<out>/s<seed>/summary.json``."""
    res = []
    for s in seeds:
        with open(os.path.join(out, f"s{s}", "summary.json")) as f:
            res.append(100.0 * json.load(f)["experiments"][cell]["JSRT_test"]["dice_mean"])
    return res


def short_runs(args, common, mode: str, dev) -> dict:
    """``check_steps`` backbone steps and head steps, twice each, in ``mode``;
    the weights of the two runs compared."""
    import torch

    from tedm_tpu_torch.train import main as train_main

    k = args.check_steps
    tail = ["--max_steps", str(k), "--ckpt_every", str(k), "--val_freq", str(100 * k), "--log_freq", str(k)]
    backbone = os.path.join(args.first, "CXR14", "run", "best")
    before = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = mode == "cudnn_deterministic"
    torch.use_deterministic_algorithms(mode == "deterministic_algorithms", warn_only=True)
    res, msgs = {}, set()
    try:
        for what, argv, corpus in (
            ("backbone", ["--experiment", "img_only"], "CXR14"),
            ("head", ["--experiment", "TEDM", "--n_labelled_images", "1", "--saved_diffusion_model", backbone],
             "JSRT"),
        ):
            ckpts = []
            for rep in (0, 1):
                log = os.path.join(args.first + "_check", mode, f"{what}{rep}")
                shutil.rmtree(log, ignore_errors=True)
                data = [a if a else os.path.join(args.root, corpus) for a in common]
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    train_main(argv + ["--log_dir", os.path.join(log, "run")] + tail + data, device=dev)
                msgs |= {str(w.message).split("\n")[0][:200] for w in caught
                         if "deterministic" in str(w.message)}
                ckpts.append(glob.glob(os.path.join(log, "**", f"step_{k}"), recursive=True)[0])
            res[what] = compare_states(*ckpts)
    finally:
        torch.backends.cudnn.deterministic = before[0]
        torch.use_deterministic_algorithms(before[1])
    res["nondeterministic_ops"] = sorted(msgs)
    return res


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, required=True, help="the corpus of the first run")
    ap.add_argument("--first", type=str, required=True, help="the --out of a finished quality_r5.py run")
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ap.add_argument("--img_size", type=int, default=64)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--backbone_steps", type=int, default=400)
    ap.add_argument("--head_steps", type=int, default=300)
    ap.add_argument("--check_steps", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                    help="arguments appended to every training command (as the first run had them)")
    args = ap.parse_args(argv)

    from tedm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cell = f"{EXPERIMENT}/{SIZE}"
    chain = ["--root", args.root, "--img_size", str(args.img_size), "--batch_size", str(args.batch_size),
             "--backbone_steps", str(args.backbone_steps), "--head_steps", str(args.head_steps),
             "--experiments", EXPERIMENT, "--sizes", str(SIZE),
             "--seeds", *map(str, args.seeds), "--device", args.device]
    extra = ["--extra", *args.extra] if args.extra else []
    same, new = args.first + "_same", args.first + "_new"
    for d in (same, new):
        shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(args.first, "CXR14"), os.path.join(same, "CXR14"))
    quality_r5.main(chain + ["--out", same] + extra)
    quality_r5.main(chain + ["--out", new] + extra)

    report = {"card": quality_r5.card(), "cell": cell, "seeds": args.seeds,
              "backbone_first_vs_new": compare_states(*(os.path.join(d, "CXR14", "run", "best")
                                                        for d in (args.first, new))),
              "dice_jsrt_test": {name: cell_dice(d, cell, args.seeds)
                                 for name, d in (("first", args.first), ("same_backbone", same),
                                                 ("new_backbone", new))}}
    common = ["--data_dir", "", "--splits_dir", os.path.join(args.root, "data"), "--img_size",
              str(args.img_size), "--batch_size", str(args.batch_size), "--num_workers", "2"] + list(args.extra)
    report["short_runs"] = {mode: short_runs(args, common, mode, dev) for mode in MODES}
    path = args.first + "_repeat.json"
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
