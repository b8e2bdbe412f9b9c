"""Paper tables and Wilcoxon significance tests from eval artifacts (port
of ``tedm_tpu/reporting/tables.py``, numpy only, scipy imported by
``wilcoxon_compare``).

Reference: auxiliary/notebooks_and_reporting/print_tests_shared_weights.py:
collects {dataset}_predictions over the logs/<exp>/<datasize>/ tree, prints
LaTeX rows of 100x Dice mean $\\pm$ std for datasizes {1,3,6,12,197} per
dataset (JSRT test / NIH / Montgomery; :161-201), appendix
precision/recall rows, and Wilcoxon signed-rank comparisons (:203-222).
The port's eval CLIs (``tedm_tpu_torch.eval.run_tests``,
``testing_shared_weights``) write the files it reads.

CLI:
    python -m tedm_tpu_torch.reporting.tables --logs logs
        [--experiments baseline LEDM LEDMe TEDM]
        [--wilcoxon TEDM LEDMe --dataset Montgomery --datasize 12 --metric dice]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

FILES_NEEDED = (
    "JSRT_val_predictions.npz",
    "JSRT_test_predictions.npz",
    "NIH_predictions.npz",
    "Montgomery_predictions.npz",
)
DATASIZES = (1, 3, 6, 12, 24, 49, 98, 197)
DISPLAY_NAMES = {
    "baseline": "Baseline",
    "LEDM": "LEDM",
    "LEDMe": "LEDMe",
    "TEDM": "TEDM (ours)",
    "PDDM": "Step (linear)",
    "global_finetune": "Global CL",
    "glob_loc_finetune": "Global & Local CL",
}


def _find_run_dir(exp_dir: str) -> Optional[str]:
    """logs/<exp>/<size>/ may hold the artifacts directly or one
    timestamped run directory below it."""
    if not os.path.isdir(exp_dir):
        return None
    if set(FILES_NEEDED) <= set(os.listdir(exp_dir)):
        return exp_dir
    for sub in sorted(os.listdir(exp_dir), reverse=True):
        p = os.path.join(exp_dir, sub)
        if os.path.isdir(p) and set(FILES_NEEDED) <= set(os.listdir(p)):
            return p
    return None


def collect_metrics(
    logs_root: str,
    experiments: Sequence[str],
    datasizes: Sequence[int] = DATASIZES,
    tedm_timesteps: Sequence[int] = (),
) -> Dict[str, np.ndarray]:
    """Flat per-image record arrays over all (exp, datasize, dataset);
    the JSRT rows come from JSRT_test (the val file is reported separately,
    matching the reference's use of files_needed[1:]).

    ``tedm_timesteps``: additionally load TEDM's per-timestep ablation
    artifacts ``{ds}_timestep{t}_predictions.npz`` (written by
    eval.testing_shared_weights) under exp labels ``Step {t} (MLP)`` —
    the reference's metrics4 block (print_tests_shared_weights.py:135-160).
    PDDM linear-probe runs evaluated into ``Step_N`` experiment dirs are
    picked up by simply listing those dir names in ``experiments``."""
    rec: Dict[str, List[np.ndarray]] = {
        "dice": [], "precision": [], "recall": [],
        "exp": [], "datasize": [], "dataset": [],
    }

    def add(run: str, fname: str, label: str, size: int) -> None:
        with np.load(os.path.join(run, fname)) as z:
            n = len(z["dice"])
            rec["dice"].append(z["dice"].squeeze())
            rec["precision"].append(z["precision"].squeeze())
            rec["recall"].append(z["recall"].squeeze())
        rec["exp"].append(np.array([label] * n))
        rec["datasize"].append(np.array([size] * n))
        rec["dataset"].append(np.array([fname.split("_")[0]] * n))

    for exp in experiments:
        for size in datasizes:
            run = _find_run_dir(os.path.join(logs_root, exp, str(size)))
            if run is None:
                print(f"Experiment {exp} {size} is missing files")
                continue
            print(f"Experiment {exp} {size}")
            for fname in FILES_NEEDED[1:]:
                add(run, fname, exp, size)
            if exp == "TEDM" and tedm_timesteps:
                for t in tedm_timesteps:
                    for fname in FILES_NEEDED[1:]:
                        ts_name = fname.replace(
                            "predictions", f"timestep{t}_predictions"
                        )
                        if os.path.exists(os.path.join(run, ts_name)):
                            add(run, ts_name, f"Step {t} (MLP)", size)
                        else:
                            print(f"  (no {ts_name})")
    return {k: (np.concatenate(v) if v else np.array([])) for k, v in rec.items()}


def _select(rec, **conds) -> np.ndarray:
    mask = np.ones(len(rec["exp"]), bool)
    for k, v in conds.items():
        mask &= rec[k] == v
    return mask


def print_main_table(
    rec: Dict[str, np.ndarray],
    experiments: Sequence[str],
    metric: str = "dice",
    datasizes: Sequence[int] = (1, 3, 6, 12, 197),
    datasets: Sequence[str] = ("JSRT", "NIH", "Montgomery"),
) -> None:
    """LaTeX rows: 100x metric mean $\\pm$ std per (exp, datasize)
    (reference formatting, print_tests_shared_weights.py:164-178)."""
    if len(rec["exp"]) == 0:
        print("(no eval artifacts found)")
        return
    for dataset in datasets:
        print(dataset)
        for exp in experiments:
            name = DISPLAY_NAMES.get(exp, exp)
            cells = []
            for size in datasizes:
                m = _select(rec, exp=exp, dataset=dataset) & (rec["datasize"] == size)
                vals = rec[metric][m] * 100
                if len(vals) == 0:
                    cells.append("--")
                else:
                    cells.append(
                        f"{round(float(np.nanmean(vals)), 2):.3} $\\pm$ "
                        f"{round(float(np.nanstd(vals)), 1)}"
                    )
            print(name + "&\t" + "&\t".join(cells) + "\\\\")


def _fmt_cell(vals: np.ndarray) -> str:
    if len(vals) == 0:
        return "--"
    return (
        f"{round(float(np.nanmean(vals)), 2):.3} $\\pm$ "
        f"{round(float(np.nanstd(vals)), 1)}"
    )


# Reference paper-table row order and display names
# (print_tests_shared_weights.py:169-171).
PAPER_ROWS = (
    ("baseline", "Baseline"),
    ("LEDM", "DatasetDDPM"),
    ("Step_1", "Step 1 (linear)"),
    ("Step 1 (MLP)", "Step 1 (MLP)"),
    ("Step 10 (MLP)", "Step 10 (MLP)"),
    ("Step 25 (MLP)", "Step 25 (MLP)"),
    ("LEDMe", "DatasetDDPMe"),
    ("TEDM", "Ours"),
)
APPENDIX_ROWS = (
    ("baseline", "Baseline"),
    ("LEDM", "LEDM"),
    ("Step_1", "Step 1 (linear)"),
    ("LEDMe", "LEDMe"),
    ("TEDM", "TEDM (ours)"),
)


def print_per_timestep_table(
    rec: Dict[str, np.ndarray],
    metric: str = "dice",
    datasizes: Sequence[int] = (1, 3, 6, 12, 197),
    datasets: Sequence[str] = ("JSRT", "NIH", "Montgomery"),
    rows: Sequence = PAPER_ROWS,
) -> None:
    """The paper's main per-timestep table block: Baseline / DatasetDDPM /
    Step-N linear + MLP probes / DatasetDDPMe / Ours, 100x metric
    mean $\\pm$ std (reference: print_tests_shared_weights.py:161-181).
    Rows whose artifacts are absent print '--' cells rather than crashing,
    so partial log trees still report."""
    if len(rec["exp"]) == 0:
        print("(no eval artifacts found)")
        return
    for dataset in datasets:
        print(dataset)
        for exp, name in rows:
            cells = []
            for size in datasizes:
                m = _select(rec, exp=exp, dataset=dataset) & (rec["datasize"] == size)
                cells.append(_fmt_cell(rec[metric][m] * 100))
            print(name + "&\t" + "&\t".join(cells) + "\\\\")


def print_appendix_table(
    rec: Dict[str, np.ndarray],
    datasizes: Sequence[int] = (1, 3, 6, 12, 197),
    datasets: Sequence[str] = ("JSRT", "NIH", "Montgomery"),
    rows: Sequence = APPENDIX_ROWS,
) -> None:
    """Appendix precision/recall blocks per dataset (reference:
    print_tests_shared_weights.py:182-201)."""
    if len(rec["exp"]) == 0:
        print("(no eval artifacts found)")
        return
    for dataset in datasets:
        print("\n" + dataset)
        for metric in ("precision", "recall"):
            print("\n" + metric)
            for exp, name in rows:
                cells = []
                for size in datasizes:
                    m = _select(rec, exp=exp, dataset=dataset) & (rec["datasize"] == size)
                    cells.append(_fmt_cell(rec[metric][m] * 100))
                print(name + "&\t" + "&\t".join(cells) + "\\\\")


def wilcoxon_compare(
    rec: Dict[str, np.ndarray],
    exp_a: str,
    exp_b: str,
    dataset: str,
    datasize: int,
    metric: str = "dice",
) -> Dict[str, float]:
    """Two-sided + one-sided Wilcoxon signed-rank tests
    (reference: print_tests_shared_weights.py:203-222)."""
    from scipy.stats import wilcoxon

    x = rec[metric][_select(rec, exp=exp_a, dataset=dataset) & (rec["datasize"] == datasize)]
    y = rec[metric][_select(rec, exp=exp_b, dataset=dataset) & (rec["datasize"] == datasize)]
    out = {}
    for alt in ("two-sided", "greater", "less"):
        out[alt] = float(wilcoxon(
            x, y=y, zero_method="wilcox", correction=False, alternative=alt
        ).pvalue)
    print(f"{metric} - {dataset} - {datasize} - {exp_a}: {x.mean():.4}+/-{x.std():.3}")
    print(f"{metric} - {dataset} - {datasize} - {exp_b}: {y.mean():.4}+/-{y.std():.3}")
    for alt, p in out.items():
        print(f"{metric} - {dataset} - {datasize}: p={p:.3} ({alt})")
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--logs", type=str, default="logs")
    parser.add_argument("--experiments", nargs="+",
                        default=["baseline", "LEDM", "LEDMe", "TEDM"])
    parser.add_argument("--metric", type=str, default="dice",
                        choices=["dice", "precision", "recall"])
    parser.add_argument("--datasizes", nargs="+", type=int,
                        default=[1, 3, 6, 12, 197])
    parser.add_argument("--wilcoxon", nargs=2, metavar=("EXP_A", "EXP_B"))
    parser.add_argument("--dataset", type=str, default="JSRT")
    parser.add_argument("--datasize", type=int, default=12)
    parser.add_argument("--per-timestep", dest="per_timestep", action="store_true",
                        help="paper per-timestep block: Step_N linear dirs + "
                             "TEDM timestep{t} artifacts (MLP rows)")
    parser.add_argument("--tedm-timesteps", dest="tedm_timesteps", nargs="+",
                        type=int, default=[1, 10, 25],
                        help="timesteps for the 'Step N (MLP)' rows")
    parser.add_argument("--appendix", action="store_true",
                        help="appendix precision/recall blocks")
    args = parser.parse_args(argv)

    rec = collect_metrics(
        args.logs, args.experiments,
        tedm_timesteps=tuple(args.tedm_timesteps) if args.per_timestep else (),
    )
    if args.per_timestep:
        print_per_timestep_table(rec, args.metric, tuple(args.datasizes))
    else:
        print_main_table(rec, args.experiments, args.metric, tuple(args.datasizes))
    if args.appendix:
        print_appendix_table(rec, tuple(args.datasizes))
    if args.wilcoxon:
        wilcoxon_compare(rec, args.wilcoxon[0], args.wilcoxon[1],
                         args.dataset, args.datasize, args.metric)


if __name__ == "__main__":
    main()
