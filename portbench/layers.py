"""The arithmetic of the per-layer metrics, shared by their readers
(``metrics/<name>.py``). Each takes the run's view (``drivers/common.py``
``view``) and the kind of unit its metric is about (``train``: a training
step; ``serve``: a served request), and returns None where the run has
nothing to read: another kind of unit, no trace, no kernel of the port.
"""

from __future__ import annotations

from typing import Dict, Optional


def _traced(view: Dict, unit: str) -> Optional[Dict]:
    return view["trace"] if view["unit"] == unit and view.get("trace") else None


def mfu(view: Dict, unit: str) -> Optional[float]:
    """% of the card's dense peak at the cell's precision: the unit's
    operations times the units of the measured window over its seconds."""
    if view["unit"] != unit or not view["units"]:
        return None
    return 100.0 * view["flops_per_unit"] * view["units"] / view["window_s"] / view["peak_flops"]


def kernel_roofline(view: Dict, unit: str) -> Optional[float]:
    """% of their bound that the port's own kernels reach: the sum of their
    calls' bounds over the traced units, over their device time there."""
    tr = _traced(view, unit)
    if tr is None:
        return None
    kernels = [k for k in view["bounds_ms"] if tr["kinds_ms"].get(k)]
    device_ms = sum(tr["kinds_ms"][k] for k in kernels)
    if not device_ms:
        return None
    return 100.0 * tr["units"] * sum(view["bounds_ms"][k] for k in kernels) / device_ms


def kinds_ms(view: Dict, unit: str, *kinds: str) -> Optional[float]:
    """Device ms of the given kinds of work per unit."""
    tr = _traced(view, unit)
    return None if tr is None else sum(tr["kinds_ms"].get(k, 0.0) for k in kinds) / tr["units"]


def idle_share(view: Dict, unit: str) -> Optional[float]:
    """% of the measured window in which no device operation runs: the
    traced units' busy seconds a unit against the window's seconds a unit.
    The profiler's own host work stretches the traced window, so its idle
    share (``busy_s`` of ``window_s``) reads higher than the window's."""
    tr = _traced(view, unit)
    if tr is None:
        return None
    return 100.0 * (1.0 - (tr["busy_s"] / tr["units"]) / (view["window_s"] / view["units"]))


def launches(view: Dict, unit: str) -> Optional[float]:
    tr = _traced(view, unit)
    return None if tr is None else tr["launches"] / tr["units"]

