"""Data parallelism over ``torch.distributed`` (port of the ``data`` axis of
``tedm_tpu/parallel/mesh.py``).

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

Without a process group (one process, no ``--multihost``) every function
here is the identity, and the trainers run exactly as on one device.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

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


def rank_seed(seed: int) -> int:
    """The seed of a rank's per-image draws (crops, brightness, diffusion t
    and noise, feature noise): ``seed`` on rank 0, so that a world of one
    draws what one process draws, and another stream on every other rank,
    as JAX draws every row of the global batch apart."""
    return seed + 1_000_003 * rank()


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
    """The port's mesh: one ``data`` axis over the ranks."""

    shape: tuple
    axis_names: tuple


def make_mesh(mesh_shape: Sequence[int] = (), mesh_axes: Sequence[str] = ("data",),
              n_devices: Optional[int] = None) -> Mesh:
    """JAX's ``make_mesh`` checks over the ranks (tedm_tpu/parallel/mesh.py:44-79):
    an empty shape takes every rank on ``data``; a shape that needs more
    devices than there are ranks, or (with more than one rank) fewer, is an
    error in JAX's words."""
    n_dev = world() if n_devices is None else n_devices
    if not mesh_shape:
        return Mesh((n_dev,), ("data",))
    n = math.prod(mesh_shape)
    if n > n_dev:
        raise ValueError(f"mesh_shape {tuple(mesh_shape)} needs {n} devices, have {n_dev}")
    if n < n_dev:
        raise ValueError(
            f"mesh_shape {tuple(mesh_shape)} uses {n} of {n_dev} global devices; in a multi-process "
            "run the mesh must cover every device (subset meshes are single-process only)"
        )
    return Mesh(tuple(mesh_shape), tuple(mesh_axes))


def param_shardings(params: Dict[str, torch.Tensor], n: int,
                    fsdp_min_size: int = 2 ** 14) -> Dict[str, Optional[int]]:
    """FSDP's rule: the dim each parameter is sharded on over ``n`` ranks,
    None where it is replicated. A parameter of at least ``fsdp_min_size``
    elements is sharded on its largest dim that ``n`` divides (the first of
    equal ones), as JAX's ``param_shardings`` under ``fsdp``
    (tedm_tpu/parallel/mesh.py:90-145); small leaves (biases, norm gains)
    stay replicated."""
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
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        parts = [torch.empty_like(x) for _ in range(world())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g.chunk(world())[rank()]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks, on every rank; autograd gives each
    rank the sum of the ranks' gradients of it."""
    return _AllReduceSum.apply(x) if world() > 1 else x


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in rank order, on every rank;
    autograd gives each rank its rows of the sum of the ranks' gradients."""
    return _GatherRows.apply(x) if world() > 1 else x


def reduced(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks (no gradient)."""
    if world() == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


def global_share(per_row: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """This rank's share of the masked mean over the valid rows of every
    rank: sum(per_row * valid) / max(global valid count, 1). The shares sum
    to the global mean; DDP's mean of per-rank means would weight a rank
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
    the trained module for DDP or FSDP, run micro-steps without their
    gradient reduction (``no_sync``), reduce the replicated parameters'
    gradients under FSDP (``finish_grads``), and read and restore the full
    state (``state_dict``, ``optimizer_state``, ``load_optimizer_state``).
    Identity without a process group."""

    def __init__(self, mode: str = "replicated", fsdp_min_size: int = 2 ** 14):
        self.world = world()
        self.mode = mode if active() else "none"
        self.fsdp_min_size = fsdp_min_size
        self._replicated: List[nn.Parameter] = []
        self._order: List[nn.Parameter] = []  # the optimizer's parameters, in the caller's order

    def wrap(self, module: nn.Module, find_unused: bool = False) -> nn.Module:
        """The module to call: ``module`` under DDP (its state stays
        ``module``'s, without a ``module.`` prefix), or ``module`` sharded in
        place by FSDP2, or ``module`` itself without a group. Only the
        parameters that take gradients are reduced; build the optimizer
        after this call (FSDP replaces the parameters)."""
        if self.mode == "none":
            return module
        if self.mode == "fsdp":
            self.shard(module)
            return module
        dev = next(module.parameters()).device
        return nn.parallel.DistributedDataParallel(
            module, device_ids=[dev] if dev.type == "cuda" else None, broadcast_buffers=False,
            find_unused_parameters=find_unused,
        )

    def shard(self, module: nn.Module) -> None:
        """FSDP2 over ``module`` by ``param_shardings``' rule: each block of
        a ``ModuleList`` is a unit of its own, then the module; the
        replicated parameters stay whole on every rank."""
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        from tedm_tpu_torch.kernels import layouts

        dev = next(module.parameters()).device
        mesh = init_device_mesh(dev.type, (self.world,), mesh_dim_names=("data",))
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
        dist.all_reduce(flat)
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
        """``module``'s full state_dict (a DDP wrapper's module's; FSDP's
        shards gathered, a collective: every rank calls it)."""
        if isinstance(module, nn.parallel.DistributedDataParallel):
            module = module.module
        return {k: _full(v) for k, v in module.state_dict().items()}

    def optimizer_state(self, optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
        """The optimizer's state_dict with FSDP's shards of Adam's moments
        gathered, keyed as one process keys it (a collective)."""
        sd = optimizer.state_dict()
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
        the moments of FSDP's parameters as the parameters are."""
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


def data_parallel_setup(config, device: Union[str, torch.device] = "cuda") -> DataParallel:
    """The trainers' wiring (the port of JAX's ``data_parallel_setup``): the
    mesh checks of ``make_mesh`` and a ``DataParallel`` for
    ``config.param_sharding``; identity without a process group."""
    make_mesh(tuple(config.mesh_shape), tuple(config.mesh_axes))
    return DataParallel(config.param_sharding, config.fsdp_min_size)


def loader_shard() -> Dict[str, int]:
    """The train loader's shard of this rank (``shard_index``,
    ``shard_count``), as JAX passes its process index and count."""
    return {"shard_index": rank(), "shard_count": world()}


def local_tensors(tensors: Iterable[torch.Tensor]) -> List[torch.Tensor]:
    return [local(t) for t in tensors]
