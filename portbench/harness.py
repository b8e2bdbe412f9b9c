"""What every cell's run shares: finding a cell's files by name, the checks
before and after a run, the statistics, and the result line.

A cell ``<cell>`` is ``workloads/<cell>.json``: its configuration's name
(``configs/<config>.json``, the model as it is run), its traffic's name
(``traffic/<traffic>.json``: the driver, ``drivers/<driver>.py``, and its
parameters) and the limits of the numbers that decide ``correct``. A
per-layer metric ``<metric>`` is read by ``metrics/<metric>.py``. Which
metrics a cell reports is ``BENCHMARK.json``'s to say.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules that may not be loaded by a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tedm_tpu")


def load_json(*parts: str) -> Dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(name: str) -> Dict:
    """The cell's file, with its configuration and traffic read in."""
    c = load_json("workloads", name + ".json")
    c["name"] = name
    c["model"] = load_json("configs", c["config"] + ".json")
    c["mix"] = load_json("traffic", c["traffic"] + ".json")
    return c


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def metric_reader(name: str):
    """``metrics/<name>.py``, loaded from its path (a name may hold dots)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(name: str, manifest: Optional[Dict] = None) -> Tuple[List[Dict], List[Dict]]:
    """The end-to-end and the per-layer metrics of ``BENCHMARK.json`` that
    the cell reports: those that list it, or list no cells."""
    if manifest is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            manifest = json.load(f)
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return mine(manifest["end_to_end"]), mine(manifest["per_layer"])


def forbidden_modules() -> List[str]:
    """The forbidden top-level names in ``sys.modules``, compared whole:
    ``tedm_tpu_torch`` is not ``tedm_tpu``."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def judge(numbers: Dict[str, Optional[float]], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """``correct`` and each number beside its limit. A number that is
    missing or not finite fails."""
    compared = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(v["value"] is not None and math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in compared.values())
    return ok, compared


def emit(result: Dict, compared: Dict[str, Dict]) -> None:
    """The compared numbers as the last lines of standard error, and the
    result as the last line of standard output, ``compared`` its last key."""
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "compared": compared}), flush=True)
