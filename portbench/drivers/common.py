"""What the drivers share: the measured window, the traced units after it,
the device's memory and the view the per-layer metrics read."""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import torch

from portbench import trace as tracing
from portbench.counts import kernels as kernel_counts
from portbench.counts import model as model_counts

# published dense peaks of one H100 SXM: an fp32 cell's products may run as
# split TF32 (the port's kernels), so no fp32 route can read above TF32's
PEAK_FLOPS = {"fp32": 495e12, "bf16": 989e12}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(unit: Callable[[int], None], first: int, seconds: float, device) -> Dict:
    """``unit(first)``, ``unit(first + 1)``, ... until the host clock has run
    ``seconds`` from the start, then a wait for the device: all the work
    and all the time of the window."""
    sync(device)
    t0 = time.perf_counter()
    i = first
    while True:
        unit(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return {"first": first, "units": i - first, "seconds": time.perf_counter() - t0}


def traced(unit: Callable[[int], None], first: int, units: int, label: str) -> Optional[Dict]:
    """The trace summary of ``units`` units after ``first`` (``trace.py``)."""
    return tracing.summarize(tracing.trace_units(unit, first, units, label), label, units)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def view(cell: Dict, unit: str, win: Dict, summary: Optional[Dict]) -> Dict:
    """What the per-layer metrics read (``layers.py``)."""
    cfg, mix = cell["model"], cell["mix"]
    batch = mix["batch"] if unit == "train" else len(cfg["t_steps"])
    bounds = kernel_counts.unit_bounds(cfg["dim"], cfg["dim_mults"], cfg["img_size"], batch,
                                       mix["precision"] == "bf16", mix["kernels"], unit == "train")
    return {"unit": unit, "units": win["units"], "window_s": win["seconds"],
            "flops_per_unit": model_counts.unit_flops(cfg, mix), "peak_flops": PEAK_FLOPS[mix["precision"]],
            "bounds_ms": bounds, "trace": summary}
