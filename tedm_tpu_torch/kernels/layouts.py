"""Weights laid out for a kernel, cached per parameter version and storage.

A kernel that reads a weight in a layout of its own (the ResnetBlock's
``wgmma`` B tiles, the PreNorm block's ``mma.sync`` A fragments) gets it
from ``cached_layout``: built once per weight, key (the kernel's and dtype's
name for the layout), version (``Tensor._version``, which an optimizer's
in-place step bumps) and storage of the weight (``w.data = t``,
``Module.to``), and kept while the weight lives. A served model builds each
layout once; a trained one once per step. A writer that changes weights
without moving their version counters (FSDP's all-gather into storage it
reuses) starts a new epoch (``new_epoch``), and every layout is rebuilt at
its next use.
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict, Hashable

import torch

# (id(w), key) -> (weakref to w, (w._version, w.data_ptr(), w.device, epoch), layout)
_cache: Dict[tuple, tuple] = {}
_epoch = 0


def new_epoch() -> None:
    """Rebuild every layout at its next use: the weights may have changed
    in place without their version counters moving."""
    global _epoch
    _epoch += 1


def cached_layout(w: torch.Tensor, key: Hashable, build: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``build(w)``, rebuilt when w's version or storage moves or a new
    epoch starts, and dropped when w is freed. An inference tensor has no version counter and is
    laid out on every call."""
    if w.is_inference():
        return build(w)
    k, state = (id(w), key), (w._version, w.data_ptr(), w.device, _epoch)
    hit = _cache.get(k)
    if hit is not None and hit[0]() is w and hit[1] == state:
        return hit[2]
    layout = build(w)
    _cache[k] = (weakref.ref(w, lambda _, k=k: _cache.pop(k, None)), state, layout)
    return layout
