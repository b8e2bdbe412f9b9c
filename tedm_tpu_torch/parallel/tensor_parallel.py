"""Tensor parallelism over the mesh's ``model`` axis (port of the ``tp`` mode
of ``tedm_tpu/parallel/mesh.py``).

JAX shards a parameter leaf on its trailing (out-channel) dim over ``model``
when the leaf has at least 2 dims, that dim is at least ``tp_min_width`` and
the axis divides it (``param_shardings(mode="tp")``, mesh.py:90-145); GSPMD
then splits the convolutions by their out-channels and gathers what the next
op needs, and around a Pallas custom call, which it cannot partition, it
gathers the call's weights and runs it whole. The numbers are those of one
device.

The port reads the same rule against JAX's leaf, not the torch tensor: a
torch weight of 2 or more dims keeps its out-channels in dim 0, where JAX's
kernel keeps them last (``utils/convert.py``), and a module whose JAX leaf
is 1-D lists the parameter in ``jax_vectors`` (``ChanLayerNorm.g``, (1, C, 1,
1) here, (C,) in JAX), which stays replicated. ``shard`` keeps each
sharded parameter's rows of this rank of the model group and gives its
module a ``Plan``; the module then computes column-parallel:

* ``Conv2d`` and ``Linear`` (``models/unet.py``) convolve with their own
  out-channel rows and their entries of the replicated bias
  (``local_rows``), then ``gather`` the channels of every rank; their input
  goes through ``enter``, whose backward adds the ranks' partial input
  gradients. The compute is split, not only the storage, and on a model
  axis of one the operations are those of one process.
* A kernel that takes a weight (B.4's ResnetBlock, B.2's PreNorm block)
  gets it whole from ``full_weight``; the kernels that take activations
  alone (B.1, B.1b, B.3, B.5) see gathered activations.

Every rank of a model group computes the same gathered activations and the
same gradients of them; the backward of a gather keeps this rank's slice.
Only ``all_gather`` and ``all_reduce`` are used (gloo on CUDA tensors has no
reduce-scatter); a sum of bf16 adds in fp32.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn


class Plan(NamedTuple):
    """A module's place on the model axis: the group, its size and this
    rank's index in it (the coordinate on ``model``)."""

    group: object
    size: int
    index: int


def jax_trailing(module: nn.Module, name: str, p: torch.Tensor) -> Optional[int]:
    """The trailing dim of JAX's leaf of ``module``'s parameter ``name``,
    None where that leaf has one dim."""
    if p.ndim < 2 or name in getattr(module, "jax_vectors", ()):
        return None
    return p.shape[0]


def plan_of(module: nn.Module, size: int, min_width: int) -> Dict[str, bool]:
    """JAX's ``tp`` rule over ``module``'s parameters: {name: sharded} on a
    model axis of ``size``."""
    out = {}
    for prefix, mod in module.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            w = jax_trailing(mod, name, p)
            out[f"{prefix}.{name}" if prefix else name] = w is not None and w >= min_width and w % size == 0
    return out


def shard(module: nn.Module, plan: Plan, min_width: int) -> None:
    """Keep this rank's rows of every parameter that the rule shards, and
    give its module ``plan``."""
    sharded = plan_of(module, plan.size, min_width)
    for prefix, mod in module.named_modules():
        for name, p in list(mod.named_parameters(recurse=False)):
            full = f"{prefix}.{name}" if prefix else name
            if not sharded[full]:
                continue
            if not hasattr(mod, "tp"):
                raise TypeError(f"{type(mod).__name__} ({full}) has no tensor-parallel forward")
            with torch.no_grad():
                p.data = p.data.chunk(plan.size, dim=0)[plan.index].clone()
            p.tp = plan
            mod.tp = plan


def is_sharded(p: torch.Tensor) -> bool:
    return getattr(p, "tp", None) is not None


def all_gather(t: torch.Tensor, plan: Plan, dim: int) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` in model-rank order (no
    gradient)."""
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(plan.size)]
    dist.all_gather(parts, src, group=plan.group)
    return torch.cat(parts, dim=dim)


def all_reduce(t: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The sum of the ranks' ``t`` (no gradient)."""
    acc = t.float() if t.dtype == torch.bfloat16 else t.clone()
    dist.all_reduce(acc, group=plan.group)
    return acc.to(t.dtype)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.plan), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.dim = plan, dim
        return all_gather(x, plan, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.plan.size, dim=ctx.dim)[ctx.plan.index].contiguous(), None, None


def enter(x: torch.Tensor, plan: Plan) -> torch.Tensor:
    """``x`` itself; its gradient is the sum of the model ranks' gradients
    (each rank's is the part of its own out-channels)."""
    return _Enter.apply(x, plan)


def gather(y: torch.Tensor, plan: Plan, dim: int) -> torch.Tensor:
    """The ranks' ``y`` concatenated on ``dim``; the gradient keeps this
    rank's slice."""
    return _Gather.apply(y, plan, dim)


def local_rows(t: Optional[torch.Tensor], plan: Plan) -> Optional[torch.Tensor]:
    """This rank's rows of a replicated ``t``; its gradient, the rows of
    every rank, comes back whole on every rank."""
    return None if t is None else enter(t, plan).chunk(plan.size, dim=0)[plan.index]


def full_weight(module: nn.Module, name: str = "weight") -> torch.Tensor:
    """``module``'s parameter ``name`` whole: gathered on dim 0 under a plan
    (its gradient this rank's rows of the full gradient), else itself."""
    p = getattr(module, name)
    return gather(p, p.tp, 0) if is_sharded(p) else p


def column(plan: Plan, x: torch.Tensor, local, dim: int = 1) -> torch.Tensor:
    """``local(x)`` on this rank's out-channels, gathered on ``dim``."""
    return gather(local(enter(x, plan)), plan, dim)


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module``'s state_dict with every sharded parameter gathered (a
    collective over the model group)."""
    params = dict(module.named_parameters())
    return {k: all_gather(v, params[k].tp, 0) if k in params and is_sharded(params[k]) else v
            for k, v in module.state_dict().items()}
