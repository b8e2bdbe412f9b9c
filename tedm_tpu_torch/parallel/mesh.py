"""Data, tensor and spatial parallelism over ``torch.distributed`` (port of
the ``data``, ``model`` and ``spatial`` axes of ``tedm_tpu/parallel/mesh.py``).

JAX runs one program over the global batch: GSPMD shards the batch over the
mesh's ``data`` axis and inserts the reductions. torch runs one process per
device, so here a rank plays the part of one JAX host with one device:

* ``--batch_size`` is per rank, as JAX's is per host
  (tedm_tpu/parallel/mesh.py:214-219); the global batch is
  ``world * batch_size``, and each rank's train loader reads the strided
  shard ``rank`` of ``world``.
* ``--param_sharding replicated`` wraps the trained module in DDP;
  ``fsdp`` in FSDP2 (``fully_shard``, each block of a ``ModuleList`` and
  then the module), its parameters and Adam's moments sharded over the ranks
  on their largest divisible dim when they hold at least ``--fsdp_min_size``
  elements, the others replicated (``param_shardings``), as JAX's rule.
* Where JAX's global program couples the rows of the batch, the port reduces
  across the ranks itself, and each rank back-propagates ``world`` times its
  share of the global loss, so that DDP's and FSDP's mean over the ranks is
  the gradient of the global loss: ``all_reduce_sum`` and ``gather_rows``
  (autograd passes the sum of the ranks' gradients back) carry BatchNorm's
  batch statistics and the contrastive losses' negatives, and
  ``global_share`` the masked mean over the valid rows of every rank.
* Decisions taken from values that differ by rank (a signal, the best
  validation loss) are taken from reduced values (``host_sum``), on a gloo
  group, so that no rank enters a collective that another skips.

* A mesh with a ``model`` axis (``--mesh_shape D M --mesh_axes data
  model``) places rank ``r`` at ``divmod(r, M)``, as JAX reshapes its
  devices row-major, and builds the data group (the ranks of one ``model``
  coordinate) and the model group (the ranks of one ``data`` coordinate)
  once. Everything above reduces over the data group only: the ranks of a
  model group read the same rows and draw the same t, noise and crops
  (``loader_shard``, ``rank_seed``), and hold the same activations.
  ``--param_sharding tp`` shards the wide weights over the model group
  (``tensor_parallel``) and wraps the module in DDP over the data group;
  under ``replicated`` or ``fsdp`` the model ranks are plain replicas, as
  in JAX.
* A mesh with a ``spatial`` axis (``--mesh_shape D S --mesh_axes data
  spatial --shard_spatial``) places rank ``r`` at ``divmod(r, S)`` and
  builds the spatial group (the ranks of one ``data`` coordinate) and the
  pixel group (the data x spatial ranks, which hold distinct pixels) once.
  The ranks of a spatial group read the same rows and draw alike, as a
  model group's do; under ``--shard_spatial`` each holds its rows of every
  map (``parallel/spatial.py``). Per-row values (the valid counts, the
  per-image losses) are the same on the ranks of a spatial group and reduce
  over the data group; sums over pixels (BatchNorm's statistics,
  ``all_reduce_sum``; PDDM's feature moments, ``reduced_pixels``) over the
  pixel group, and DDP averages over it. Each rank still back-propagates
  the data axis's size times its share of the loss: the spatial reductions
  hand each rank S times its rows' part of the gradient (``spatial.py``).
* Any other axis name (``--mesh_shape 2 2 --mesh_axes data replica``), as
  JAX's ``make_mesh`` takes any: nothing shards over it, so its ranks are
  replicas, which read the same rows, draw alike and compute the same
  values, and which no reduction group holds. A mesh without a ``data``
  axis is refused on more than one rank, in JAX's words (its batch
  sharding names ``data``).

Without a process group (one process, no ``--multihost``) every function
here is the identity, and the trainers run exactly as on one device.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tedm_tpu_torch.parallel import spatial, tensor_parallel

# a collective that waits longer than this fails instead of hanging: a rank
# that skipped a collective, or died, ends the run
TIMEOUT = datetime.timedelta(seconds=600)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")

_host_group = None  # (gloo group for host-side reductions, its default group); None: the default group


def _host():
    return None if _host_group is None else _host_group[0]


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


class _Axes(NamedTuple):
    key: tuple                 # (mesh shape, axis names, the default group) it was built for
    data: Any                  # the data group (None: the default group)
    model: Any                 # the model group (None: no model axis)
    data_size: int
    data_rank: int
    model_size: int
    model_rank: int
    spatial: Any = None        # the spatial group (None: no spatial axis)
    spatial_size: int = 1
    spatial_rank: int = 0
    pixels: Any = None         # the data x spatial group (None: the data group)


_axes: Optional[_Axes] = None  # the mesh's groups; None: one data axis over the default group


def _current() -> Optional[_Axes]:
    if _axes is None or not active() or _axes.key[2] is not dist.group.WORLD:
        return None
    return _axes


def data_group():
    """The group the data axis reduces over (None: the default group)."""
    a = _current()
    return None if a is None else a.data


def data_world() -> int:
    a = _current()
    return world() if a is None else a.data_size


def data_rank() -> int:
    a = _current()
    return rank() if a is None else a.data_rank


def model_world() -> int:
    a = _current()
    return 1 if a is None else a.model_size


def spatial_world() -> int:
    a = _current()
    return 1 if a is None else a.spatial_size


def spatial_rank() -> int:
    a = _current()
    return 0 if a is None else a.spatial_rank


def spatial_plan() -> Optional[spatial.Plan]:
    """This rank's place on the ``spatial`` axis, None without one."""
    a = _current()
    return None if a is None or a.spatial is None else spatial.Plan(a.spatial, a.spatial_size, a.spatial_rank)


def pixel_group():
    """The group of the ranks that hold distinct pixels, data x spatial
    (the data group without a spatial axis)."""
    a = _current()
    return None if a is None else (a.pixels if a.spatial is not None else a.data)


def model_plan() -> Optional[tensor_parallel.Plan]:
    """This rank's place on the ``model`` axis, None without one."""
    a = _current()
    return None if a is None or a.model is None else tensor_parallel.Plan(a.model, a.model_size, a.model_rank)


def rank_seed(seed: int) -> int:
    """The seed of a rank's per-image draws (crops, brightness, diffusion t
    and noise, feature noise): ``seed`` on data rank 0, so that a world of
    one draws what one process draws, and another stream on every other
    data rank, as JAX draws every row of the global batch apart; the ranks
    of one model or spatial group draw alike."""
    return seed + 1_000_003 * data_rank()


def init_multihost(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``--multihost`` (tedm_tpu/train.py:60-77): join the process group
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``, ``MASTER_PORT``), NCCL with ``cuda:LOCAL_RANK`` on the
    card and gloo on the CPU, and return the rank's device. A caller that
    has set up the default group itself keeps it. Without either it raises:
    ``--multihost`` never runs quietly as one process."""
    global _host_group
    dev = torch.device(device)
    if not active():
        missing = [k for k in TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"--multihost needs torchrun's environment ({', '.join(missing)} unset): launch with "
                "`torchrun --nproc_per_node N -m tedm_tpu_torch.train --multihost ...`"
            )
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", 0))
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", timeout=TIMEOUT, device_id=dev)
        else:
            dist.init_process_group("gloo", timeout=TIMEOUT)
    elif dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.get_backend() == "gloo":
        _host_group = None
    elif _host_group is None or _host_group[1] is not dist.group.WORLD:  # once per default group
        _host_group = (dist.new_group(backend="gloo", timeout=TIMEOUT), dist.group.WORLD)
    n = world()
    print(f"multihost: process {rank()}/{n}, {n} global devices", flush=True)
    return dev


class Mesh(NamedTuple):
    """The port's mesh: its shape and axis names (``data``, ``model``,
    ``spatial`` and any other, whose ranks are replicas)."""

    shape: tuple
    axis_names: tuple


def make_mesh(mesh_shape: Sequence[int] = (), mesh_axes: Sequence[str] = ("data",),
              n_devices: Optional[int] = None) -> Mesh:
    """JAX's ``make_mesh`` checks over the ranks (tedm_tpu/parallel/mesh.py:44-79):
    an empty shape takes every rank on one axis, named by the first of
    ``mesh_axes`` (``data`` when there is none); a shape that needs more
    devices than there are ranks, or (with more than one rank) fewer, is an
    error in JAX's words. Over the ranks of a process group (``n_devices``
    None) it also builds the mesh's data, model and spatial groups, once
    per mesh."""
    n_dev = world() if n_devices is None else n_devices
    if not mesh_shape:
        m = Mesh((n_dev,), axis_names((), mesh_axes))
    else:
        if len(mesh_shape) != len(mesh_axes):
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} and mesh_axes {tuple(mesh_axes)} differ in length")
        n = math.prod(mesh_shape)
        if n > n_dev:
            raise ValueError(f"mesh_shape {tuple(mesh_shape)} needs {n} devices, have {n_dev}")
        if n < n_dev:
            raise ValueError(
                f"mesh_shape {tuple(mesh_shape)} uses {n} of {n_dev} global devices; in a multi-process "
                "run the mesh must cover every device (subset meshes are single-process only)"
            )
        m = Mesh(tuple(mesh_shape), tuple(mesh_axes))
    if n_devices is None and active():
        _use(m)
    return m


def axis_names(mesh_shape: Sequence[int], mesh_axes: Sequence[str]) -> tuple:
    """The mesh's axis names as JAX's ``make_mesh`` keeps them: all of
    ``mesh_axes`` under a shape, the first alone under an empty one
    (tedm_tpu/parallel/mesh.py:60-61)."""
    return tuple(mesh_axes) if mesh_shape else (tuple(mesh_axes[:1]) or ("data",))


def _groups_along(ranks: np.ndarray, axes: Sequence[Optional[int]]) -> List[List[int]]:
    """The rank lists of the lines of ``ranks`` along ``axes`` together (each
    rank alone when the mesh has none of them)."""
    axes = [a for a in axes if a is not None]
    if not axes:
        return [[int(r)] for r in ranks.reshape(-1)]
    n = math.prod(ranks.shape[a] for a in axes)
    return np.moveaxis(ranks, axes, list(range(-len(axes), 0))).reshape(-1, n).tolist()


def _use(m: Mesh) -> None:
    """Build ``m``'s data, model and spatial groups (and the data x spatial
    one) over the default group, unless they are built; every rank calls it
    alike (``new_group`` is a collective). On a mesh of the data axis alone
    the data group is the default one; the ranks along any other axis are
    replicas, in none of these groups."""
    global _axes
    key = (m.shape, m.axis_names, dist.group.WORLD)
    if _axes is not None and _axes.key == key:
        return
    if m.axis_names == ("data",):
        _axes = _Axes(key, None, None, world(), rank(), 1, 0)
        return
    ranks = np.arange(world()).reshape(m.shape)
    di, mi, si = (m.axis_names.index(a) if a in m.axis_names else None for a in ("data", "model", "spatial"))
    where = np.argwhere(ranks == rank())[0]
    group = lambda *axes: dist.new_subgroups_by_enumeration(_groups_along(ranks, axes), timeout=TIMEOUT)[0]
    size = lambda i: 1 if i is None else m.shape[i]
    at = lambda i: 0 if i is None else int(where[i])
    data = group(di)
    model = None if mi is None else group(mi)
    spatial_group, pixels = (None, None) if si is None else (group(si), group(di, si))
    _axes = _Axes(key, data, model, size(di), at(di), size(mi), at(mi), spatial_group, size(si), at(si), pixels)


def param_shardings(params: Dict[str, torch.Tensor], n: int,
                    fsdp_min_size: int = 2 ** 14) -> Dict[str, Optional[int]]:
    """FSDP's rule: the dim each parameter is sharded on over ``n`` ranks,
    None where it is replicated. A parameter of at least ``fsdp_min_size``
    elements is sharded on its largest dim that ``n`` divides (the first of
    equal ones), as JAX's ``param_shardings`` under ``fsdp``
    (tedm_tpu/parallel/mesh.py:90-145); small leaves (biases, norm gains)
    stay replicated. The ``tp`` rule is ``tensor_parallel.plan_of``."""
    out = {}
    for name, p in params.items():
        dims = [i for i in range(p.ndim) if p.shape[i] % n == 0]
        big = p.ndim >= 1 and p.numel() >= fsdp_min_size and dims
        out[name] = max(dims, key=lambda i: p.shape[i]) if big else None
    return out


# ------------------------------------------------------------ collectives


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y, group=pixel_group())
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=pixel_group())
        return g


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(data_world())]
        dist.all_gather(parts, x.contiguous(), group=data_group())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=data_group())
        return g.chunk(data_world())[data_rank()]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x``, a sum over pixels, over the data x spatial ranks,
    on every rank; autograd gives each rank the sum of the ranks' gradients
    of it."""
    return _AllReduceSum.apply(x) if data_world() * spatial_world() > 1 else x


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` concatenated on dim 0 in rank order, on every
    rank; autograd gives each rank its rows of the sum of the ranks'
    gradients."""
    return _GatherRows.apply(x) if data_world() > 1 else x


def reduced(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data ranks (no gradient)."""
    if data_world() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=data_group())
    return x


def reduced_pixels(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x``, a sum over pixels, over the data x spatial ranks
    (no gradient)."""
    if data_world() * spatial_world() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=pixel_group())
    return x


def global_share(per_row: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """This rank's share of the masked mean over the valid rows of every
    data rank: sum(per_row * valid) / max(global valid count, 1). The shares
    sum to the global mean; DDP's mean of per-rank means would weight a rank
    with fewer valid rows (a padded shard) as much as a full one."""
    count = reduced(valid.sum()).clamp(min=1.0)
    return (per_row * valid).sum() / count


def host_sum(values: Sequence[float]) -> List[float]:
    """The sums over the ranks of a few host numbers, on a gloo group, with
    no device synchronisation."""
    if world() == 1:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64)
    dist.all_reduce(t, group=_host())
    return t.tolist()


def rows_seen(n: int) -> float:
    """The rows that the data ranks read, from each rank's ``n`` (the ranks
    of a model or spatial group, and replicas, read the same rows)."""
    return host_sum([n])[0] * data_world() / world()


def host_any(flag: bool) -> bool:
    """True on every rank when it is true on any (a signal seen by one)."""
    return host_sum([float(flag)])[0] > 0


def barrier() -> None:
    """Wait for every rank (on the host group)."""
    if world() > 1:
        dist.barrier(group=_host())


def broadcast(x: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``x`` on every rank (in place)."""
    if world() > 1:
        dist.broadcast(x, src=0)
    return x


# --------------------------------------------------------------- modules


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A sharded parameter's local shard, any other tensor itself."""
    return t.to_local() if _is_dtensor(t) else t


def _full(t):
    return t.full_tensor() if _is_dtensor(t) else t


class DataParallel:
    """The trainers' side of the mesh (``data_parallel_setup``): ``wrap``
    the trained module for DDP, FSDP or TP, ``place`` a module that is not
    trained (the EMA, a frozen backbone) as the trained one is placed, run
    micro-steps without their gradient reduction (``no_sync``), reduce the
    replicated parameters' gradients under FSDP (``finish_grads``), and read
    and restore the full state (``state_dict``, ``optimizer_state``,
    ``load_optimizer_state``), and under ``shard_spatial`` give the spatial
    plan of a batch (``rows_plan``). Identity without a process group."""

    def __init__(self, mode: str = "replicated", fsdp_min_size: int = 2 ** 14, tp_min_width: int = 256,
                 shard_spatial: bool = False):
        self.world = data_world()
        self.mode = mode if active() else "none"
        self.plan = model_plan()
        self.spatial = spatial_plan() if shard_spatial else None
        if self.mode == "tp" and self.plan is None:
            raise ValueError(TP_NEEDS_MODEL)
        self.fsdp_min_size = fsdp_min_size
        self.tp_min_width = tp_min_width
        self._replicated: List[nn.Parameter] = []
        self._order: List[nn.Parameter] = []  # the optimizer's parameters, in the caller's order

    def rows_plan(self, height: int, depth: int) -> Optional[spatial.Plan]:
        """The spatial plan of a batch of maps of ``height`` rows through a
        UNet of ``depth`` downsamples (``spatial.plan_for``): None without
        ``--shard_spatial``, a spatial axis of one, or a height the axis does
        not divide."""
        return spatial.plan_for(self.spatial, height, depth)

    def wrap(self, module: nn.Module, find_unused: bool = False) -> nn.Module:
        """The module to call: ``module`` under DDP over the data x spatial
        group (the data group without a spatial axis; its
        state stays ``module``'s, without a ``module.`` prefix), under TP
        first sharded over the model group, or ``module`` sharded in place
        by FSDP2, or ``module`` itself without a group. Only the parameters
        that take gradients are reduced; build the optimizer after this call
        (FSDP and TP replace the parameters)."""
        if self.mode == "none":
            return module
        if self.mode == "fsdp":
            self.shard(module)
            return module
        if self.mode == "tp":
            self.place(module)
        dev = next(module.parameters()).device
        return nn.parallel.DistributedDataParallel(
            module, device_ids=[dev] if dev.type == "cuda" else None, broadcast_buffers=False,
            find_unused_parameters=find_unused, process_group=pixel_group(),
        )

    def place(self, module: nn.Module) -> None:
        """Shard ``module`` in place as the trained module is sharded: by
        FSDP2, or by the ``tp`` rule over the model group (``tensor_parallel``);
        nothing otherwise."""
        if self.mode == "fsdp":
            self.shard(module)
        elif self.mode == "tp":
            tensor_parallel.shard(module, self.plan, self.tp_min_width)

    def shard(self, module: nn.Module) -> None:
        """FSDP2 over ``module`` by ``param_shardings``' rule: each block of
        a ``ModuleList`` is a unit of its own, then the module; the
        replicated parameters stay whole on every rank. On a mesh with a
        model axis the data group's ranks shard and the model ranks are
        replicas."""
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        from tedm_tpu_torch.kernels import layouts

        dev = next(module.parameters()).device
        if data_group() is None:
            mesh = init_device_mesh(dev.type, (self.world,), mesh_dim_names=("data",))
        else:
            mesh = DeviceMesh.from_group(data_group(), dev.type, mesh_dim_names=("data",))
        dims = param_shardings(dict(module.named_parameters()), self.world, self.fsdp_min_size)
        by_param = {p: dims[n] for n, p in module.named_parameters()}
        replicated = [p for p, d in by_param.items() if d is None]  # in the module's order, on every rank
        self._replicated += [p for p in replicated if p.requires_grad]
        kw = dict(mesh=mesh, ignored_params=set(replicated), shard_placement_fn=lambda p: Shard(by_param[p]))
        units = [m for parent in module.modules() if isinstance(parent, nn.ModuleList)
                 for m in parent if not isinstance(m, nn.ModuleList)]
        for unit in units:
            fully_shard(unit, **kw)
        fully_shard(module, **kw)
        # FSDP writes the gathered weights into storage it frees after each
        # forward without moving their version counters, and the allocator can
        # hand the same address back: a weight layout cached by (version,
        # address) would outlive an optimizer step. Each forward starts a new
        # layout epoch.
        for unit in units + [module]:
            unit.register_forward_pre_hook(lambda *_: layouts.new_epoch())

    @contextlib.contextmanager
    def no_sync(self, module: nn.Module, sync: bool):
        """Run a micro-step with (``sync``) or without the gradient reduction."""
        if self.mode == "none" or sync:
            yield
        elif self.mode == "fsdp":
            module.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                module.set_requires_gradient_sync(True)
        else:
            with module.no_sync():
                yield

    def finish_grads(self) -> None:
        """Under FSDP, the mean over the ranks of the replicated parameters'
        gradients (DDP and FSDP reduce the others in the backward)."""
        grads = [p.grad for p in self._replicated if p.grad is not None]
        if self.mode != "fsdp" or not grads:
            return
        flat = torch.cat([g.flatten() for g in grads])
        dist.all_reduce(flat, group=data_group())
        flat /= self.world
        torch._foreach_copy_(grads, [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)])

    def optimizer_params(self, params: Iterable[nn.Parameter]):
        """What to build the optimizer from: ``params``, or under FSDP two
        groups of them, the sharded ones and the replicated ones (a foreach
        step cannot mix DTensors with tensors). ``optimizer_state`` and
        ``load_optimizer_state`` keep one process's layout of the state."""
        params = list(params)
        if self.mode != "fsdp":
            return params
        self._order = params
        groups = [[p for p in params if _is_dtensor(p)], [p for p in params if not _is_dtensor(p)]]
        return [{"params": g} for g in groups if g]

    def _positions(self, optimizer: torch.optim.Optimizer) -> List[int]:
        """The caller's index of each of the optimizer's parameters, in the
        optimizer's order (its groups in turn)."""
        pos = {id(p): i for i, p in enumerate(self._order)}
        return [pos[id(p)] for g in optimizer.param_groups for p in g["params"]]

    def state_dict(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """``module``'s full state_dict (a DDP wrapper's module's; FSDP's and
        TP's shards gathered, a collective: every rank calls it)."""
        if isinstance(module, nn.parallel.DistributedDataParallel):
            module = module.module
        if self.mode == "tp":
            return tensor_parallel.full_state_dict(module)
        return {k: _full(v) for k, v in module.state_dict().items()}

    def _flat_params(self, optimizer: torch.optim.Optimizer) -> List[nn.Parameter]:
        return [p for g in optimizer.param_groups for p in g["params"]]

    def optimizer_state(self, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
        """The optimizer's state_dict with FSDP's and TP's shards of Adam's
        moments gathered, keyed as one process keys it (a collective)."""
        sd = optimizer.state_dict()
        if self.mode == "tp":
            params = self._flat_params(optimizer)
            whole = lambda p, v: (tensor_parallel.all_gather(v, p.tp, 0)
                                  if tensor_parallel.is_sharded(p) and torch.is_tensor(v) and v.shape == p.shape else v)
            sd["state"] = {i: {k: whole(params[i], v) for k, v in s.items()} for i, s in sd["state"].items()}
            return sd
        sd["state"] = {i: {k: _full(v) for k, v in s.items()} for i, s in sd["state"].items()}
        if self.mode == "fsdp":  # one group, indexed as the caller ordered the parameters
            pos = self._positions(optimizer)
            group = {k: v for k, v in sd["param_groups"][0].items() if k != "params"}
            sd = {"state": {pos[j]: s for j, s in sorted(sd["state"].items(), key=lambda js: pos[js[0]])},
                  "param_groups": [{**group, "params": list(range(len(pos)))}]}
        return sd

    def load_optimizer_state(self, optimizer: torch.optim.Optimizer, state: Dict[str, Any]) -> None:
        """Restore a full optimizer state (``optimizer_state``'s, or one
        process's) into an optimizer over this rank's parameters, sharding
        the moments of FSDP's and TP's parameters as the parameters are."""
        if self.mode == "tp":
            params = self._flat_params(optimizer)
            mine = lambda p, v: (v.chunk(p.tp.size, dim=0)[p.tp.index].clone()
                                 if tensor_parallel.is_sharded(p) and torch.is_tensor(v) and v.ndim == p.ndim
                                 and v.shape[0] == p.shape[0] * p.tp.size else v)
            optimizer.load_state_dict({**state, "state": {i: {k: mine(params[i], v) for k, v in s.items()}
                                                          for i, s in state["state"].items()}})
            return
        if self.mode != "fsdp":
            optimizer.load_state_dict(state)
            return
        pos = self._positions(optimizer)
        group = {k: v for k, v in state["param_groups"][0].items() if k != "params"}
        at = {i: j for j, i in enumerate(pos)}
        groups, start = [], 0
        for g in optimizer.param_groups:
            groups.append({**group, "params": list(range(start, start + len(g["params"])))})
            start += len(g["params"])
        optimizer.load_state_dict({"state": {at[i]: s for i, s in state["state"].items()}, "param_groups": groups})
        from torch.distributed.tensor import distribute_tensor

        for group in optimizer.param_groups:
            for p in group["params"]:
                st = optimizer.state.get(p, {})
                for k, v in st.items():
                    if _is_dtensor(p) and torch.is_tensor(v) and v.shape == p.shape and not _is_dtensor(v):
                        st[k] = distribute_tensor(v.to(p.device), p.device_mesh, p.placements)


TP_NEEDS_MODEL = ("--param_sharding tp needs a 'model' mesh axis, e.g. "
                  "--mesh_shape 4 2 --mesh_axes data model")


SP_NEEDS_AXIS = ("--shard_spatial needs a 'spatial' mesh axis, e.g. "
                 "--mesh_shape 2 4 --mesh_axes data spatial")
SP_COMPOSES = ("--shard_spatial composes only with replicated params and a "
               "single spatial axis (got param_sharding={mode!r}, mesh axes "
               "{axes}): XLA's SPMD partitioner miscompiles the "
               "conv backward when partitioning spans two non-batch factors "
               "(measured grad error up to 2.4 rel-l2 while the forward "
               "matches — silent wrong training; docs/DESIGN.md). Use "
               "data x spatial with replicated params, or TP/FSDP without SP.")


def check_config(config) -> None:
    """JAX's refusals, in its words: ``tp`` without a ``model`` axis
    (tedm_tpu/parallel/mesh.py:181-185); and, where JAX's wiring runs past
    its one-device return (mesh.py:177-179: more than one rank here), a
    mesh without a ``data`` axis (its batch sharding, mesh.py:225, names
    one), and ``--shard_spatial`` without a ``spatial`` axis, or with
    ``tp``, ``fsdp`` or a second spatial axis (mesh.py:186-212). The mesh's
    axis names are JAX's ``make_mesh``'s (``axis_names``)."""
    axes = axis_names(config.mesh_shape, config.mesh_axes)
    if config.param_sharding == "tp" and "model" not in axes:
        raise ValueError(TP_NEEDS_MODEL)
    if world() <= 1:
        return
    if "data" not in axes:
        raise ValueError(f"Resource axis: data of PartitionSpec('data',) is not found in mesh: {axes}.")
    if not config.shard_spatial:
        return
    if "spatial" not in axes:
        raise ValueError(SP_NEEDS_AXIS)
    if config.param_sharding in ("tp", "fsdp") or "spatial2" in axes:
        raise ValueError(SP_COMPOSES.format(mode=config.param_sharding, axes=axes))


def data_parallel_setup(config, device: Union[str, torch.device] = "cuda") -> DataParallel:
    """The trainers' wiring (the port of JAX's ``data_parallel_setup``): the
    mesh checks of ``make_mesh`` (and its groups) and a ``DataParallel`` for
    ``config.param_sharding`` (and the spatial plan under
    ``--shard_spatial``); identity without a process group."""
    check_config(config)
    make_mesh(tuple(config.mesh_shape), tuple(config.mesh_axes))
    return DataParallel(config.param_sharding, config.fsdp_min_size, config.tp_min_width, config.shard_spatial)


def loader_shard() -> Dict[str, int]:
    """The train loader's shard of this rank (``shard_index``,
    ``shard_count``): its data rank and the data axis's size, as JAX passes
    its process index and count; the ranks of a model or spatial group read
    alike."""
    return {"shard_index": data_rank(), "shard_count": data_world()}


def local_tensors(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    return [local(t) for t in tensors]
