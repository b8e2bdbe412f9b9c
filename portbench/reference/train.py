"""The plain reference of the backbone's training steps: the UNet's L1
epsilon loss on q-sampled images, its gradient, one Adam step (torch's
defaults: betas (0.9, 0.999), eps 1e-8, no weight decay) and the EMA of the
weights, x <- decay * x + (1 - decay) * w, after it.

A step runs its batch in blocks of ``rows``, each block's share of the
batch mean back-propagated on its own and the gradients added, so the
reference fits beside the cell's batch whatever its size.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference import precision
from portbench.reference.diffusion import Schedule

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


class Record:
    """What three training steps produce, as compared: each step's loss;
    the first step's gradient, its norm a leaf; the change of each leaf's
    weights and of its EMA after the third step, their norms."""

    def __init__(self, losses: Sequence[float], grad: Dict[str, float], change: Dict[str, float],
                 ema_change: Dict[str, float]):
        self.losses, self.grad, self.change, self.ema_change = list(losses), grad, change, ema_change


def _norms(names: Sequence[str], tensors: Sequence[torch.Tensor]) -> Dict[str, float]:
    return dict(zip(names, torch.stack(torch._foreach_norm(list(tensors))).tolist()))


def loss_and_grad(unet, sched: Schedule, x: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                  rows: int, out_rounding: precision.Rounding = None) -> float:
    """The batch loss, its gradient left in the parameters' ``.grad``; the
    UNet's output (and its gradient) rounded by ``out_rounding``."""
    b = x.shape[0]
    total = 0.0
    for i in range(0, b, rows):
        s = slice(i, i + rows)
        out = precision.apply(out_rounding, unet(sched.q_sample(x[s] * 2 - 1, t[s], noise[s]), t[s]))
        loss = sched.loss_sum(out, noise[s], t[s]) / b
        loss.backward()
        total += loss.item()
    return total


def run(unet, sched: Schedule, batches: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
        lr: float, ema_decay: float, rows: int, out_rounding: precision.Rounding = None) -> Record:
    """Train ``unet`` (holding the initial weights) through ``batches``, each
    (x in [0, 1], t, noise); returns the record."""
    names, params = zip(*unet.named_parameters())
    start = [p.detach().clone() for p in params]
    ema = [p.detach().clone() for p in params]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses: List[float] = []
    grad = {}
    for k, (x, t, noise) in enumerate(batches, start=1):
        for p in params:
            p.grad = None
        losses.append(loss_and_grad(unet, sched, x, t, noise, rows, out_rounding))
        with torch.no_grad():
            if k == 1:
                grad = _norms(names, [p.grad for p in params])
            for p, mi, vi in zip(params, m, v):
                mi.mul_(BETA1).add_(p.grad, alpha=1 - BETA1)
                vi.mul_(BETA2).addcmul_(p.grad, p.grad, value=1 - BETA2)
                denom = (vi / (1 - BETA2 ** k)).sqrt_().add_(EPS)
                p.addcdiv_(mi, denom, value=-lr / (1 - BETA1 ** k))
            for e, p in zip(ema, params):
                e.mul_(ema_decay).add_(p, alpha=1 - ema_decay)
    with torch.no_grad():
        change = _norms(names, [p - s for p, s in zip(params, start)])
        ema_change = _norms(names, [e - s for e, s in zip(ema, start)])
    return Record(losses, grad, change, ema_change)
