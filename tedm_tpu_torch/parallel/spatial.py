"""Spatial parallelism over the mesh's ``spatial`` axis (port of
``--shard_spatial`` in ``tedm_tpu/parallel/mesh.py``, whose partitioning
XLA's SPMD partitioner does and which has no file of its own in JAX).

JAX shards every image batch ``(B, H, W, C)`` whose H the spatial axis
divides as ``P("data", "spatial")`` (mesh.py:241-249); GSPMD then partitions
each convolution with a halo exchange and reduces what couples the rows.
Here each rank of a spatial group of ``S`` ranks holds the rows ``[j H/S,
(j+1) H/S)`` of every map of one batch (``local_rows``), ``j`` its index in
the group, and the UNet (``models/unet.py``) reads the ``Plan`` that
``sharded`` makes current:

* a convolution of more than one row (3x3 pad 1, the 7x7 ``init_conv``, the
  4x4 stride-2 downsample) takes ``halo`` rows of its neighbours first (of
  the whole map where a rank holds fewer rows than the halo reaches) and
  convolves with no row padding; 1x1 convolutions, the nearest upsample and
  ChanLayerNorm (over channels) stay local;
* GroupNorm's sums and sums of squares per (sample, group), and the losses'
  sums over pixels, go through ``spatial_sum``;
* the attentions (B.1, B.2, B.5, the plain mid attention) and the kernels
  that take a whole map (B.3, B.4) run on ``gather_h`` of their input and
  keep this rank's rows of their output.

The shape rule (``plan_for``): a batch whose H the spatial axis does not
divide is not sharded, as in JAX; one that it divides must split evenly at
every stage of the UNet (each downsample halves the rows, and a 4x4
stride-2 conv needs an even number of them), else it is refused. JAX's only
condition is the first (tedm_tpu/parallel/mesh.py:244-247), but where a
stage does not split evenly its partitioner is not right either: at 32^2
over 8 row shards with 3 downsamples (4 rows a rank, so 4 rows of the
deepest stage over 8 shards) its loss matches one device's, but its
gradients of the second conv's kernel (``block2``) of every ResnetBlock of
the 4^2 stage are exactly twice one device's, so the port refuses such
shapes rather than train to a wrong reference.

Every rank of a spatial group computes the same values of what has no H
axis (the time embedding, FiLM, the per-image losses). Each ``spatial_sum``
and ``gather_h`` passes the sum of the ranks' gradients back, so each rank
back-propagates the gradient of the global loss through its own rows, S
times: each rank back-propagates the data axis's size times its share of
the loss (``parallel/mesh.py``), and DDP's mean over the data x spatial
ranks is the gradient of the global loss.

Only ``all_gather`` and ``all_reduce`` are used (gloo on CUDA tensors has
no reduce-scatter, and an all-gather of the edge rows stands in for
``send``/``recv``); a sum of bf16 adds in fp32. Beside ``local_rows``,
``halo``, ``gather_h`` and ``spatial_sum`` stands a plain one-process
version, ``*_reference``, that the tests check them against. Without a
current plan every function here is the identity.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F


class Plan(NamedTuple):
    """This rank's place on the spatial axis: the group, its size and this
    rank's index in it (its row block)."""

    group: Any
    size: int
    index: int


_plan: Optional[Plan] = None


def plan() -> Optional[Plan]:
    """The current plan: the maps in flight are this rank's rows (None: whole maps)."""
    return _plan


def world() -> int:
    return 1 if _plan is None else _plan.size


@contextlib.contextmanager
def sharded(p: Optional[Plan]):
    """Make ``p`` current inside the block (None: whole maps). The backward
    of a checkpointed block (``--remat``) recomputes under the plan, so the
    block holds the backward too."""
    global _plan
    old, _plan = _plan, p
    try:
        yield
    finally:
        _plan = old


def plan_for(p: Optional[Plan], height: int, depth: int) -> Optional[Plan]:
    """The plan under which a batch of maps of ``height`` rows runs through a
    UNet with ``depth`` downsamples: ``p`` when its size divides ``height``
    (JAX's input rule), None when it does not (every rank of the group then
    computes the whole map, as JAX leaves such a batch unsharded). A batch
    that ``p`` divides but whose rows do not split evenly at every stage is
    refused (the module docstring gives a shape where JAX's gradients are
    wrong)."""
    if p is None or p.size == 1 or height % p.size:
        return None
    rows = height // p.size
    if rows % 2 ** depth:
        raise ValueError(
            f"--shard_spatial: {height} rows over a spatial axis of {p.size} leave {rows} a rank; every stage "
            f"of a UNet with {depth} downsamples must split evenly (rows a rank divisible by {2 ** depth}); JAX's "
            "partitioner runs such a batch, but at 32^2 over 8 row shards its gradients of the deepest stage's "
            "block2 convs are twice one device's"
        )
    return p


# ------------------------------------------------------------ collectives


def _all_gather(t: torch.Tensor, p: Plan) -> List[torch.Tensor]:
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(p.size)]
    dist.all_gather(parts, src, group=p.group)
    return parts


def _all_reduce(t: torch.Tensor, p: Plan) -> torch.Tensor:
    acc = t.float() if t.dtype == torch.bfloat16 else t.clone()
    dist.all_reduce(acc, group=p.group)
    return acc.to(t.dtype)


def _rows_of(p: Plan, h: int) -> slice:
    return slice(p.index * h, (p.index + 1) * h)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows (dim 2) of a whole NCHW map, contiguous; the
    gradient of the others' rows is zero. The map itself without a plan."""
    if _plan is None:
        return x
    return x[:, :, _rows_of(_plan, x.shape[2] // _plan.size)].contiguous()


def local_rows_reference(x: torch.Tensor, size: int, index: int) -> torch.Tensor:
    return x.chunk(size, dim=2)[index]


def local_size(height: int) -> int:
    """The rows a rank holds of a map of ``height`` rows."""
    return height // world()


def randn(shape: Sequence[int], generator: Optional[torch.Generator], device, dtype) -> torch.Tensor:
    """Normal noise of a local map of ``shape``: drawn for the whole map (H
    times the group's size) and cut to this rank's rows, so that the ranks
    of a group, drawing alike, hold the noise one process draws."""
    if generator is None:
        raise ValueError("need a generator or the noise itself")
    if _plan is None:
        return torch.randn(tuple(shape), generator=generator, device=device, dtype=dtype)
    full = (shape[0], shape[1], shape[2] * _plan.size, *shape[3:])
    return local_rows(torch.randn(full, generator=generator, device=device, dtype=dtype))


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p, above, below):
        ctx.p, ctx.above, ctx.below = p, above, below
        b, c, h, w = x.shape
        # every rank sends its first `below` rows (its upper neighbour's
        # lower halo) and its last `above` rows (its lower neighbour's upper one)
        parts = _all_gather(torch.cat([x[:, :, :below], x[:, :, h - above:]], dim=2), p)
        j = p.index
        top = parts[j - 1][:, :, below:] if j > 0 else x.new_zeros(b, c, above, w)
        bottom = parts[j + 1][:, :, :below] if j < p.size - 1 else x.new_zeros(b, c, below, w)
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g):
        p, above, below = ctx.p, ctx.above, ctx.below
        h = g.shape[2] - above - below
        parts = _all_gather(torch.cat([g[:, :, :above], g[:, :, above + h:]], dim=2), p)
        return return_halo_grads(g[:, :, above:above + h].clone(), parts, p, above, below), None, None, None


def return_halo_grads(own: torch.Tensor, parts: List[torch.Tensor], p: Plan, above: int, below: int) -> torch.Tensor:
    """Add to ``own``, the gradient of this rank's rows, the gradients its
    neighbours hold of them as halo rows: the lower neighbour's upper halo
    is this rank's last ``above`` rows, the upper neighbour's lower halo its
    first ``below`` rows. ``parts[r]`` is rank r's (upper halo, lower halo)
    gradient rows."""
    h, j = own.shape[2], p.index
    if j < p.size - 1 and above:
        own[:, :, h - above:] += parts[j + 1][:, :, :above]
    if j > 0 and below:
        own[:, :, :below] += parts[j - 1][:, :, above:]
    return own


def halo(x: torch.Tensor, above: int, below: int) -> torch.Tensor:
    """This rank's rows of ``x`` with ``above`` rows of its upper neighbour's
    above them and ``below`` of its lower neighbour's below, zeros at the
    map's edges: a conv with no row padding over it gives this rank's rows
    of the row-padded conv of the whole map. The backward sends each halo
    row's gradient back to the rank that holds the row and adds it there.
    Where this rank holds fewer rows than the halo reaches, the halo rows
    come from the whole map (``gather_h``). ``x`` itself without a plan."""
    if _plan is None:
        return x
    h = x.shape[2]
    if h < max(above, below):
        return F.pad(gather_h(x), (0, 0, above, below))[:, :, _plan.index * h:_plan.index * h + h + above + below]
    return _Halo.apply(x, _plan, above, below)


def halo_reference(x: torch.Tensor, size: int, index: int, above: int, below: int) -> torch.Tensor:
    h = x.shape[2] // size
    padded = F.pad(x, (0, 0, above, below))
    return padded[:, :, index * h:index * h + h + above + below]


def conv2d(conv: torch.nn.Conv2d, x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """``conv`` (a k x k convolution, stride s, padding p) over this rank's
    rows: the halo of p rows above and k - 1 - p below, then the conv
    without row padding (at stride 2 with an even number of rows a rank
    the last row is not read)."""
    k, pad = conv.kernel_size[0], conv.padding[0]
    return F.conv2d(halo(x, pad, k - 1 - pad), weight, bias, conv.stride, (0, conv.padding[1]), conv.dilation,
                    conv.groups)


class _GatherH(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return torch.cat(_all_gather(x, p), dim=2)

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        g = _all_reduce(g, p)
        return g[:, :, _rows_of(p, g.shape[2] // p.size)].contiguous(), None


def gather_h(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` concatenated along H in rank order: the
    whole map, on every rank. The backward sums the ranks' gradients and
    keeps this rank's rows. ``x`` itself without a plan."""
    if _plan is None:
        return x
    return _GatherH.apply(x, _plan)


def gather_h_reference(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat(list(parts), dim=2)


class _SpatialSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return _all_reduce(x, p)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.p), None


def spatial_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the spatial group, on every rank;
    its gradient is the sum of the ranks' gradients. ``x`` itself without a
    plan."""
    if _plan is None:
        return x
    return _SpatialSum.apply(x, _plan)


def spatial_sum_reference(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack(list(parts)).sum(dim=0)


def mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The mean of ``x`` over ``dim`` of the whole map, whose rows the ranks
    share: ``x.mean(dim)`` without a plan, else the ``spatial_sum`` of the
    local sums over the whole map's count."""
    if _plan is None:
        return x.mean(dim=dim)
    return spatial_sum(x.sum(dim=dim)) / (x.shape[dim] * _plan.size)


def group_stats(x: torch.Tensor, groups: int, eps: float):
    """GroupNorm's (mean, rstd) of each (sample, group) of the whole map
    from this rank's rows, each (B, groups, 1), fp32, with the one-pass
    variance clamped at 0 (``kernels.groupnorm.group_stats`` on the whole
    map)."""
    xf = x.float().reshape(x.shape[0], groups, -1)
    sums = spatial_sum(torch.stack([xf.sum(dim=2, keepdim=True), (xf * xf).sum(dim=2, keepdim=True)]))
    n = xf.shape[2] * world()
    m, ex2 = sums[0] / n, sums[1] / n
    return m, torch.rsqrt(torch.clamp(ex2 - m * m, min=0.0) + eps)
