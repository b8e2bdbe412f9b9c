"""Figures: per-timestep boxplots and qualitative prediction grids (port of
``tedm_tpu/reporting/figures.py``; matplotlib and ``scipy.ndimage`` are
imported by the functions that draw).

Reference: auxiliary/notebooks_and_reporting/generate_figures.py (per-
timestep Dice/precision/recall boxplots over the Step_N and TEDM
timestep artifacts, :41-121) and visualisations.py (prediction grids with
mask boundaries, :43-161). Matplotlib renders to PDF/PNG; no seaborn.

CLI:
    python -m tedm_tpu_torch.reporting.figures boxplot --experiment <TEDM dir> --out fig.pdf
    python -m tedm_tpu_torch.reporting.figures grid --experiment <dir> --dataset JSRT_test --out vis.pdf
"""

from __future__ import annotations

import argparse
import os
import re
from typing import Dict, List

import numpy as np


def collect_per_timestep(exp_dir: str, dataset: str = "JSRT_test") -> Dict[int, dict]:
    """{timestep: output dict} from {dataset}_timestep{t}_predictions.npz."""
    pat = re.compile(rf"{re.escape(dataset)}_timestep(\d+)_predictions\.npz")
    out = {}
    for f in os.listdir(exp_dir):
        m = pat.fullmatch(f)
        if m:
            with np.load(os.path.join(exp_dir, f)) as z:
                out[int(m.group(1))] = {k: z[k] for k in z.files}
    return dict(sorted(out.items()))


def per_timestep_boxplot(
    exp_dir: str, out_path: str, dataset: str = "JSRT_test",
    metrics: List[str] = ("dice",),
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = collect_per_timestep(exp_dir, dataset)
    if not data:
        raise ValueError(f"no per-timestep artifacts for {dataset} in {exp_dir}")
    steps = list(data.keys())
    fig, axes = plt.subplots(1, len(metrics), figsize=(4 * len(metrics), 3.2),
                             squeeze=False)
    for ax, metric in zip(axes[0], metrics):
        vals = [data[t][metric].squeeze() * 100 for t in steps]
        ax.boxplot(vals, tick_labels=[str(t) for t in steps])
        ax.set_xlabel("diffusion timestep")
        ax.set_ylabel(f"{metric} x100")
        ax.set_title(dataset)
    fig.tight_layout()
    fig.savefig(out_path)
    print(f"wrote {out_path}")


def protocol_boxplot(
    logs_root: str, out_path: str,
    experiments: List[str] = ("baseline", "LEDM", "TEDM"),
    datasizes: List[int] = (1, 3, 6, 12),
    metrics: List[str] = ("dice",),
    datasets: List[str] = ("JSRT", "NIH", "Montgomery"),
) -> None:
    """The paper's headline figure: grouped boxplots of per-image metric vs
    training-set size, one box per experiment at each n (reference
    print_tests_shared_weights.py:66-85 'results_shared_weights.pdf',
    seaborn hue=exp — rendered here with plain matplotlib offsets)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from tedm_tpu_torch.reporting.tables import collect_metrics

    rec = collect_metrics(logs_root, experiments, datasizes)
    if len(rec["exp"]) == 0:
        raise ValueError(f"no eval artifacts under {logs_root}")
    fig, axes = plt.subplots(
        len(datasets), len(metrics),
        figsize=(1.2 + 2.4 * len(datasizes) * 0.9, 2.8 * len(datasets)),
        squeeze=False)
    width = 0.8 / len(experiments)
    colors = plt.cm.tab10.colors
    for i, dataset in enumerate(datasets):
        for j, metric in enumerate(metrics):
            ax = axes[i][j]
            for e, exp in enumerate(experiments):
                data, positions = [], []
                for s, size in enumerate(datasizes):
                    m = ((rec["exp"] == exp) & (rec["dataset"] == dataset)
                         & (rec["datasize"] == size))
                    if m.any():
                        data.append(rec[metric][m] * 100)
                        positions.append(s + (e - (len(experiments) - 1) / 2)
                                         * width)
                if data:
                    bp = ax.boxplot(
                        data, positions=positions, widths=width * 0.85,
                        showfliers=False, patch_artist=True,
                        medianprops={"color": "black"})
                    for box in bp["boxes"]:
                        box.set_facecolor(colors[e % len(colors)])
            ax.set_xticks(range(len(datasizes)))
            ax.set_xticklabels([str(s) for s in datasizes])
            ax.set_xlabel("training dataset size")
            ax.set_ylabel(f"{metric} x100")
            ax.set_title(dataset)
            ax.legend(
                handles=[plt.Rectangle((0, 0), 1, 1,
                                       fc=colors[e % len(colors)])
                         for e in range(len(experiments))],
                labels=list(experiments), loc="lower right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path)
    print(f"wrote {out_path}")


def qualitative_grid(
    exp_dir: str, out_path: str, dataset: str = "JSRT_test", n: int = 6
) -> None:
    """Rows of (prediction>0.5, ground truth, overlay) like
    visualisations.py's prediction grids."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(os.path.join(exp_dir, f"{dataset}_predictions.npz")) as z:
        y_hat, y_star = z["y_hat"], z["y_star"]
    n = min(n, len(y_hat))
    fig, axes = plt.subplots(n, 3, figsize=(7, 2.2 * n), squeeze=False)
    for i in range(n):
        pred = (y_hat[i, ..., 0] > 0.5).astype(float)
        gt = y_star[i, ..., 0]
        axes[i][0].imshow(pred, cmap="gray"); axes[i][0].set_title("prediction")
        axes[i][1].imshow(gt, cmap="gray"); axes[i][1].set_title("ground truth")
        overlay = np.stack([pred, gt, np.zeros_like(gt)], axis=-1)
        axes[i][2].imshow(overlay); axes[i][2].set_title("overlay (R=pred, G=gt)")
        for ax in axes[i]:
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path)
    print(f"wrote {out_path}")


def comparison_grid(
    exp_dirs: dict, out_path: str, dataset: str = "JSRT_test", n: int = 5
) -> None:
    """Side-by-side method comparison: one row per test image, columns =
    ground truth + each method's thresholded prediction with its Dice
    (the reference's multi-method qualitative figures,
    visualisations.py:43-161)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    loaded = {}
    for name, d in exp_dirs.items():
        with np.load(os.path.join(d, f"{dataset}_predictions.npz")) as z:
            loaded[name] = {k: z[k] for k in ("y_hat", "y_star", "dice")}
    first = next(iter(loaded.values()))
    n = min(n, len(first["y_star"]))
    cols = 1 + len(loaded)
    fig, axes = plt.subplots(n, cols, figsize=(2.2 * cols, 2.2 * n), squeeze=False)
    for i in range(n):
        axes[i][0].imshow(first["y_star"][i, ..., 0], cmap="gray")
        axes[i][0].set_title("ground truth" if i == 0 else "")
        for j, (name, out) in enumerate(loaded.items(), start=1):
            axes[i][j].imshow((out["y_hat"][i, ..., 0] > 0.5), cmap="gray")
            d = float(np.nanmean(out["dice"][i]))
            axes[i][j].set_title(f"{name}" if i == 0 else "", fontsize=9)
            axes[i][j].set_xlabel(f"dice {d:.2f}", fontsize=8)
        for ax in axes[i]:
            ax.set_xticks([]); ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path)
    print(f"wrote {out_path}")


def _contour(mask: np.ndarray) -> np.ndarray:
    """One-pixel outer boundary of a binary mask (the serve demo's
    boundary-marking trick, reference app.py:97-110)."""
    from scipy import ndimage

    m = mask.astype(bool)
    return ndimage.binary_dilation(m) & ~m


def _load_inputs(exp_dir: str, dataset: str, n: int) -> np.ndarray:
    """Input images for a figure, reloaded through the experiment's own
    config + loaders (the eval npz stores predictions/GT only; the
    reference figure script likewise re-instantiates the datasets,
    visualisations.py:37-43)."""
    from tedm_tpu_torch.config import Config
    from tedm_tpu_torch.eval.harness import build_test_loaders

    # MetricsLogger only writes config.txt when logging is enabled; the
    # checkpoint's best/config.json is always written — fall back to it so
    # debug-mode or hand-assembled experiment dirs still render.
    cfg_path = os.path.join(exp_dir, "config.txt")
    if not os.path.exists(cfg_path):
        cfg_path = os.path.join(exp_dir, "best", "config.json")
    cfg = Config.load(cfg_path)
    loaders = build_test_loaders(cfg)
    imgs: List[np.ndarray] = []
    for b in loaders[dataset]:
        keep = b["valid"] > 0
        imgs.extend(b["image"][keep])
        if len(imgs) >= n:
            break
    return np.stack(imgs[:n])


def boundary_overlay_grid(
    exp_dirs: dict, out_path: str, dataset: str = "JSRT_test", n: int = 5
) -> None:
    """The paper's qualitative comparison with the input image as underlay:
    one row per test image; first column = image with the ground-truth
    boundary (green); one column per method = image with that method's
    predicted boundary (red) over the faint GT boundary, captioned with its
    Dice (reference: visualisations.py:43-161 image/GT/prediction panels +
    app.py:97-110 boundary overlay, combined into the stronger artifact)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    loaded = {}
    for name, d in exp_dirs.items():
        with np.load(os.path.join(d, f"{dataset}_predictions.npz")) as z:
            loaded[name] = {k: z[k] for k in ("y_hat", "y_star", "dice")}
    first_dir = next(iter(exp_dirs.values()))
    first = next(iter(loaded.values()))
    n = min(n, len(first["y_star"]))
    imgs = _load_inputs(first_dir, dataset, n)

    cols = 1 + len(loaded)
    fig, axes = plt.subplots(n, cols, figsize=(2.4 * cols, 2.4 * n), squeeze=False)
    for i in range(n):
        base = imgs[i, ..., 0]
        gt = first["y_star"][i, ..., 0] > 0.5
        rgb = np.stack([base, base, base], axis=-1)
        rgb[_contour(gt)] = (0.0, 1.0, 0.0)
        axes[i][0].imshow(np.clip(rgb, 0, 1))
        axes[i][0].set_title("image + GT" if i == 0 else "", fontsize=9)
        for j, (name, out) in enumerate(loaded.items(), start=1):
            pred = out["y_hat"][i, ..., 0] > 0.5
            rgb = np.stack([base, base, base], axis=-1)
            rgb[_contour(gt)] = (0.35, 0.75, 0.35)  # faint GT reference
            rgb[_contour(pred)] = (1.0, 0.0, 0.0)
            axes[i][j].imshow(np.clip(rgb, 0, 1))
            axes[i][j].set_title(name if i == 0 else "", fontsize=9)
            axes[i][j].set_xlabel(
                f"dice {float(np.nanmean(out['dice'][i])):.2f}", fontsize=8
            )
        for ax in axes[i]:
            ax.set_xticks([]); ax.set_yticks([])
    fig.tight_layout()
    fig.savefig(out_path)
    print(f"wrote {out_path}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("kind", choices=["boxplot", "grid", "compare",
                                         "overlay", "protocol"])
    parser.add_argument("--experiment", "-e", type=str,
                        help="experiment dir (boxplot/grid)")
    parser.add_argument("--experiments", nargs="+", default=[],
                        help="NAME=DIR pairs (compare) or experiment names "
                             "(protocol)")
    parser.add_argument("--dataset", type=str, default="JSRT_test")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--metrics", nargs="+", default=["dice", "precision", "recall"])
    parser.add_argument("--n", type=int, default=6)
    parser.add_argument("--logs_root", type=str, default=None,
                        help="protocol: root holding <exp>/<n>/... eval dirs")
    parser.add_argument("--datasizes", nargs="+", type=int,
                        default=[1, 3, 6, 12])
    args = parser.parse_args(argv)
    if args.kind == "protocol":
        if not args.logs_root:
            parser.error("protocol requires --logs_root")
        protocol_boxplot(
            args.logs_root, args.out,
            experiments=args.experiments or ["baseline", "LEDM", "TEDM"],
            datasizes=args.datasizes, metrics=args.metrics)
        return
    if args.kind in ("boxplot", "grid") and not args.experiment:
        parser.error(f"{args.kind} requires --experiment")
    if args.kind in ("compare", "overlay") and not args.experiments:
        parser.error(f"{args.kind} requires --experiments NAME=DIR [NAME=DIR ...]")
    if args.kind == "boxplot":
        per_timestep_boxplot(args.experiment, args.out, args.dataset, args.metrics)
    elif args.kind == "grid":
        qualitative_grid(args.experiment, args.out, args.dataset, args.n)
    elif args.kind == "overlay":
        pairs = dict(p.split("=", 1) for p in args.experiments)
        boundary_overlay_grid(pairs, args.out, args.dataset, args.n)
    else:
        pairs = dict(p.split("=", 1) for p in args.experiments)
        comparison_grid(pairs, args.out, args.dataset, args.n)


if __name__ == "__main__":
    main()
