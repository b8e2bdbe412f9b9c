"""The traced part of a run: ``torch.profiler`` over a fixed number of units
of the cell's work, after its measured window, and the reduction of its
events to what the per-layer metrics read.

Device work is grouped by kind from the kernel's name (``KINDS``, the
grouping of ``chip_smoke.py``'s profiles): first the port's own kernels,
B.1 to B.5 by the names of their launches, then cuDNN's and cuBLAS's
convolutions and products, the optimizer's foreach kernels, reductions and
elementwise work. The window runs from the first traced unit's host span
to the end of the last unit's host span or device work, whichever is later.
The device is busy where some operation runs: the union of their intervals.
An idle gap is named by the benchmark's span around it and the innermost
host operation under way at its middle.
"""

from __future__ import annotations

import bisect
import collections
from typing import Callable, Dict, List, Optional, Tuple

import torch

SPAN = "portbench."
KINDS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("linear_attention", ("la_cluster", "context_chunks", "apply_chunks")),
    ("linear_attention_backward", ("grad_q", "grad_kv")),
    ("prenorm_linear_attention", ("kv_context", "apply_block")),
    ("fused_group_norm_film_silu", ("gn_cluster", "gn_partials", "gn_apply")),
    ("fused_resnet_block", ("conv_tc", "res_tc", "gn_coefs", "finish_identity")),
    ("fused_resnet_block_backward", ("gn_bwd_reduce", "gn_bwd_coefs", "gn_bwd_apply")),
    ("flash_cosine_attention", ("row_norms", "flash_fwd", "flash_row")),
    ("conv", ("conv", "cudnn", "xmma", "gemm", "fft", "dgrad", "wgrad", "pointwise_mult_and_sum_complex")),
    ("optimizer", ("multi_tensor", "foreach")),
    ("reduction", ("reduce", "softmax", "norm")),
    ("elementwise", ("elementwise", "copy", "cat", "index", "fill")),
)
NAMED_GAPS = 400  # the longest gaps are named one by one; the rest are summed as short


def kind_of(name: str) -> str:
    low = name.lower()
    return next((k for k, subs in KINDS if any(s in low for s in subs)), "other")


def trace_units(unit: Callable[[int], None], first: int, units: int, label: str):
    """Run ``unit(first)`` (untraced: the profiler's first event can be
    lost) and ``unit(first + 1 .. first + units)`` under the profiler, each
    in a span; returns the profiler's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN + "warm"):
            unit(first)
        torch.cuda.synchronize()
        for i in range(first + 1, first + 1 + units):
            with record_function(SPAN + label):
                unit(i)
        torch.cuda.synchronize()
    return prof.events()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def summarize(events, label: str, units: int) -> Optional[Dict]:
    """The traced window's numbers, in seconds and ms, or None where the
    profiler saw no device work in it."""
    from torch.autograd import DeviceType

    spans = sorted((e for e in events if e.name == SPAN + label and e.device_type == DeviceType.CPU),
                   key=lambda e: e.time_range.start)
    if len(spans) != units:
        return None
    w0 = spans[0].time_range.start
    device = [e for e in events if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
              and e.time_range.start >= w0]
    if not device:
        return None
    w1 = max(spans[-1].time_range.end, max(e.time_range.end for e in device))
    busy = _merge([(e.time_range.start, min(e.time_range.end, w1)) for e in device])
    busy_us = sum(e - s for s, e in busy)
    kinds: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        us = e.time_range.end - e.time_range.start
        kinds[kind_of(e.name)] += us / 1e3
        by_name[e.name[:160]] += us / 1e6
    gaps = [(s, e) for s, e in zip([w0] + [b[1] for b in busy], [b[0] for b in busy] + [w1]) if e > s]
    return {"units": units, "window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6, "launches": len(device),
            "kinds_ms": dict(kinds),
            "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda r: -r[1])[:10],
            "idle_gaps": _name_gaps(events, gaps, spans[0].thread)}


def _name_gaps(events, gaps: List[Tuple[float, float]], thread: int) -> List[List]:
    """Idle seconds by what the host was doing, the longest first."""
    from torch.autograd import DeviceType

    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.thread == thread), key=lambda r: r[0])
    starts = [h[0] for h in host]
    totals: Dict[str, float] = collections.defaultdict(float)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    for s, e in gaps[:NAMED_GAPS]:
        mid = 0.5 * (s + e)
        span, op = "outside spans", "python"
        for h in reversed(host[:bisect.bisect_right(starts, mid)]):
            if h[1] >= mid:
                if h[2].startswith(SPAN):
                    span = h[2][len(SPAN):]
                    break
                if op == "python":
                    op = h[2]
        totals[f"{span}: {op}"] += (e - s) / 1e6
    rest = sum(e - s for s, e in gaps[NAMED_GAPS:]) / 1e6
    if rest > 0:
        totals["shorter gaps"] += rest
    return sorted(([n, s] for n, s in totals.items()), key=lambda r: -r[1])[:10]
