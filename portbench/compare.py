"""The numbers that decide ``correct``, each set against a limit in the
cell's file (``workloads/<cell>.json``).

Training, from ``reference.train.Record`` of the program and of the
reference over the same first three steps:
- ``loss_gap``: the largest relative gap of a step's loss; ``loss1_gap``
  the first step's;
- ``grad_gap``: the first step's gradient, the largest gap between the
  program's norm of a leaf and the reference's, over the reference's norm of
  that leaf or of the median leaf, whichever is larger; ``grad_median_gap``
  the median leaf's gap;
- ``change_gap`` and ``ema_gap`` (and their ``_median_gap``): the same for
  the change of the weights and of their EMA after the third step, over the
  leaves that the reference's gradient moves: a leaf whose first gradient is
  under a thousandth of the median leaf's moves by round-off alone under
  Adam, and is left out.
A cell's limits name the numbers it compares.

Serving: ``prob_gap``, the largest gap of a pixel's probability (the mean of
the sigmoids over the folded timesteps) over the sampled requests.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Sequence, Tuple

import torch

MOVED = 1e-3  # a leaf counts in the change when its gradient is above this share of the median leaf's


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]) -> Dict[str, float]:
    floor = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor, 1e-30) for k in leaves}


def training(prog, ref) -> Tuple[Dict[str, Optional[float]], Dict]:
    """The numbers, and where the worst of each lies (for the readings)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]
    leaves = list(ref.grad)
    median_grad = statistics.median(ref.grad.values())
    moved = [k for k in leaves if ref.grad[k] >= MOVED * median_grad]
    gaps = {"grad": _leaf_gaps(prog.grad, ref.grad, leaves), "change": _leaf_gaps(prog.change, ref.change, moved),
            "ema": _leaf_gaps(prog.ema_change, ref.ema_change, moved)}
    numbers = {"loss_gap": max(losses) if len(losses) == len(ref.losses) else None,
               "loss1_gap": losses[0] if losses else None}
    for name, g in gaps.items():
        numbers[name + "_gap"] = max(g.values())
        numbers[name + "_median_gap"] = statistics.median(g.values())
    detail = {"losses": losses, "leaf_gaps": gaps}
    return numbers, detail


def serving(prog: Sequence[torch.Tensor], ref: Sequence[torch.Tensor]) -> Dict[str, Optional[float]]:
    if not prog or len(prog) != len(ref):
        return {"prob_gap": None}
    return {"prob_gap": max((p.float() - r.float()).abs().max().item() for p, r in zip(prog, ref))}
