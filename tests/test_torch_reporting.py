"""The port's reporting (``tedm_tpu_torch.reporting``) against the JAX
package's (``tedm_tpu.reporting``) on the same eval files, on the CPU.

A logs tree of ``{set}_predictions.npz`` files as the eval CLIs write them
(baseline, LEDM and TEDM at n = 1 and 3, TEDM with per-timestep files; 20
images a set, per-image metrics from a seed, a few NaN) feeds both packages'
CLIs: the main table, the per-timestep block, the appendix and a Wilcoxon
comparison print identical text, and the Wilcoxon p-values are equal. The
figures write their file, and every array each figure draws
(``Axes.boxplot``'s and ``Axes.imshow``'s inputs, recorded) equals JAX's
exactly. ``tedm_tpu_torch.reporting`` imports with matplotlib and pandas
blocked.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tedm_tpu.reporting import figures as jfigures
from tedm_tpu.reporting import tables as jtables
from tedm_tpu_torch.config import Config
from tedm_tpu_torch.reporting import figures, tables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETS = ("JSRT_val", "JSRT_test", "NIH", "Montgomery")
T_STEPS = (1, 10, 25)


def write_set(path, rs, n=20, size=8):
    y_star = (rs.rand(n, size, size, 1) > 0.5).astype(np.float32)
    metrics = {k: rs.rand(n, 1).astype(np.float32) for k in ("dice", "precision", "recall")}
    metrics["precision"][3] = np.nan
    np.savez_compressed(path, y_hat=rs.rand(n, size, size, 1).astype(np.float32), y_star=y_star, **metrics)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    root = tmp_path_factory.mktemp("logs")
    rs = np.random.RandomState(0)
    for exp in ("baseline", "LEDM", "TEDM"):
        for size in (1, 3):
            run = root / exp / str(size) / "2024-01-01"
            os.makedirs(run)
            for s in SETS:
                write_set(run / f"{s}_predictions.npz", rs)
                if exp == "TEDM":
                    for t in T_STEPS:
                        write_set(run / f"{s}_timestep{t}_predictions.npz", rs)
    cfg = Config(experiment="TEDM", img_size=8, batch_size=4, synthetic_data=True, n_labelled_images=1)
    cfg.save(str(root / "TEDM" / "1" / "2024-01-01" / "config.txt"))
    return str(root)


ARGVS = [
    [],
    ["--experiments", "baseline", "LEDM", "TEDM", "--datasizes", "1", "3", "--appendix"],
    ["--per-timestep", "--experiments", "baseline", "TEDM", "--datasizes", "1", "3"],
    ["--experiments", "baseline", "TEDM", "--metric", "recall", "--wilcoxon", "TEDM", "baseline", "--dataset", "NIH",
     "--datasize", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=["default", "appendix", "per-timestep", "wilcoxon"])
def test_tables_print_jax_text(logs, capsys, argv):
    tables.main(["--logs", logs, *argv])
    ours = capsys.readouterr().out
    jtables.main(["--logs", logs, *argv])
    assert ours == capsys.readouterr().out
    assert "\\\\" in ours


def test_wilcoxon_p_values_equal_jax(logs):
    rec, jrec = tables.collect_metrics(logs, ["baseline", "TEDM"]), jtables.collect_metrics(logs, ["baseline", "TEDM"])
    for k in rec:
        np.testing.assert_array_equal(rec[k], jrec[k])
    for dataset in ("JSRT", "NIH", "Montgomery"):
        got = tables.wilcoxon_compare(rec, "TEDM", "baseline", dataset, 1)
        assert got == jtables.wilcoxon_compare(jrec, "TEDM", "baseline", dataset, 1)
        assert 0.0 < got["two-sided"] <= 1.0


def drawn(module, fn, *args, **kw):
    """What ``fn`` of ``module`` draws: the arrays given to every
    ``Axes.boxplot`` and ``Axes.imshow`` call, in order."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib.axes import Axes

    calls = []
    box, show = Axes.boxplot, Axes.imshow

    def record_box(self, x, *a, **k):
        calls.append(("boxplot", [np.asarray(v) for v in x]))
        return box(self, x, *a, **k)

    def record_show(self, x, *a, **k):
        calls.append(("imshow", [np.asarray(x)]))
        return show(self, x, *a, **k)

    Axes.boxplot, Axes.imshow = record_box, record_show
    try:
        getattr(module, fn)(*args, **kw)
    finally:
        Axes.boxplot, Axes.imshow = box, show
    return calls


FIGURES = [
    ("per_timestep_boxplot", lambda run, logs: (run,), {"metrics": ["dice", "precision"]}),
    ("protocol_boxplot", lambda run, logs: (logs,), {"datasizes": [1, 3]}),
    ("qualitative_grid", lambda run, logs: (run,), {"n": 3}),
    ("comparison_grid", lambda run, logs: ({"TEDM": run, "again": run},), {"n": 3}),
    ("boundary_overlay_grid", lambda run, logs: ({"TEDM": run},), {"n": 2}),
]


@pytest.mark.parametrize("fn,args,kw", FIGURES, ids=[f[0] for f in FIGURES])
def test_figures_draw_jax_arrays(logs, tmp_path, fn, args, kw):
    run = os.path.join(logs, "TEDM", "1", "2024-01-01")
    ours = drawn(figures, fn, *args(run, logs), str(tmp_path / "port.png"), **kw)
    theirs = drawn(jfigures, fn, *args(run, logs), str(tmp_path / "jax.png"), **kw)
    assert os.path.getsize(tmp_path / "port.png") > 0
    assert [k for k, _ in ours] == [k for k, _ in theirs] and ours
    for (_, a), (_, b) in zip(ours, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_reporting_imports_without_matplotlib_and_pandas():
    code = ("import sys; sys.modules['matplotlib'] = None; sys.modules['pandas'] = None; "
            "import tedm_tpu_torch.reporting.tables, tedm_tpu_torch.reporting.figures, "
            "tedm_tpu_torch.data.make_splits; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
