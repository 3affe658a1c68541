"""``deepspeed_tpu_torch.comm``: the communication facade over
``torch.distributed`` (counterpart of ``deepspeed_tpu/comm/comm.py``).

Two layers, as in the JAX package:

1. **Collectives by mesh axis name**, with the JAX signatures
   (``all_reduce`` :64, ``all_gather`` :83, ``reduce_scatter`` :90,
   ``broadcast`` :122, ``axis_index`` :130). An axis name (or a tuple of
   them) resolves to that mesh dimension's process group in the default
   topology (``parallel/mesh.py``); None is the whole world. Where XLA
   returns a new array the port works on tensors in place and returns
   them: ``all_reduce`` and ``broadcast`` change ``x``, ``all_gather`` and
   ``reduce_scatter`` write ``out`` (made when not given), so a step
   function can hold them in a CUDA graph. Each call is synchronous on the
   host side (``async_op=False``: the current stream waits for the
   collective), and each records itself with the ``CommsLogger``. A
   collective on a one-rank axis still runs through its group (at world 1
   a one-rank NCCL group), so the path is the same at every size.
   ``ReduceOp.AVG`` is a SUM and a division (gloo's AVG depends on the
   torch version). ``all_to_all_single`` (JAX :97) runs over a data
   axis; over tp, pp, ep or sp it raises until those axes are ported
   (ROADMAP A.9), as ``ppermute`` does.

   ``axis_index_groups`` (the JAX ``lax`` collectives' argument, which the
   compressed and hierarchical exchanges pass) splits the axis into
   disjoint groups of equal size, given as indices along the axis: the
   collective then runs within this rank's group only. Each partition's
   process groups are made once (``index_group``), by every rank in the
   same order, at its first use; ``log_name`` and ``level`` label the
   comms logger's record (``comm/logging.py``).

2. **Process management**: ``init_distributed`` (JAX :140) initialises the
   default process group, NCCL for CUDA cards (after
   ``torch.cuda.set_device(local_rank)``: one card per rank) and gloo on
   the CPU, from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
   ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or explicit arguments;
   with no rendezvous given, a one-rank group on an in-memory store.
   ``get_rank``, ``get_world_size``, ``get_local_rank``,
   ``get_local_device_count``, ``barrier`` and ``is_initialized`` (JAX
   :280-311).

NCCL creates a communicator at the first collective on a group (and its
point-to-point connections at the first all-to-all), which must not happen
inside a CUDA graph capture: ``warm_up`` runs an all-reduce and an
all-to-all on each group a step will use, sub-groups included, before any
capture.
"""

import math
import os
from datetime import timedelta
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm.logging import comms_logger
from deepspeed_tpu_torch.parallel.mesh import get_default_topology
from deepspeed_tpu_torch.utils.logging import log_dist, logger

Axis = Union[None, str, Sequence[str]]


class ReduceOp:
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}

_local_rank: Optional[int] = None


# ---------------------------------------------------------------------------
# axis names -> process groups
# ---------------------------------------------------------------------------
def _resolve(axis: Axis):
    """``(group, size)`` of ``axis``: None or a set of axes spanning every
    rank is the default group; one axis is its mesh dimension's group."""
    if not is_initialized():
        raise RuntimeError("collectives need an initialised process group "
                           "(comm.init_distributed)")
    if axis is None:
        return dist.group.WORLD, dist.get_world_size()
    topo = get_default_topology()
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    size = math.prod(topo.size(a) for a in axes)
    if size == topo.num_devices:
        return dist.group.WORLD, size
    active = [a for a in axes if topo.size(a) > 1]
    if len(active) > 1:
        raise NotImplementedError(
            f"a collective over several mesh axes {axes} that do not span "
            "the world is not ported yet (ROADMAP A.9)")
    return topo.group(active[0] if active else axes[0]), size


def _world_of(axis: Axis) -> int:
    return _resolve(axis)[1]


# (axis, groups, mesh shape) -> this rank's group of the partition, and
# its size
_index_groups = {}


def _check_groups(groups) -> Tuple[Tuple[int, ...], ...]:
    groups = tuple(tuple(int(i) for i in g) for g in groups)
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(
            f"axis_index_groups must be equal-size, got sizes {sizes}")
    return groups


def index_group(axis: str, groups):
    """``(group, size)``: the process group of this rank's part of the
    partition ``groups`` of ``axis`` (lists of indices along the axis,
    disjoint, of equal size, covering it). The first call makes every part's
    group for every slice of the mesh along ``axis``, in one order on every
    rank (``new_group`` is a collective of the whole world); later calls
    return it from a cache."""
    groups = _check_groups(groups)
    topo = get_default_topology()
    key = (axis, groups, topo.shape)
    if key not in _index_groups:
        if not is_initialized():
            raise RuntimeError("collectives need an initialised process "
                               "group (comm.init_distributed)")
        if sorted(i for g in groups for i in g) != list(range(topo.size(axis))):
            raise ValueError(f"axis_index_groups {groups} do not partition "
                             f"the {axis} axis of {topo.size(axis)} ranks")
        me = dist.get_rank()
        mine = None
        for base in topo.filter_ranks(**{axis: 0}):
            coords = topo.coord_of(base)
            for g in groups:
                ranks = [r for i in g for r in topo.filter_ranks(
                    **dict(coords, **{axis: i}))]
                group = dist.new_group(ranks)
                if me in ranks:
                    mine = group
        _index_groups[key] = (mine, len(groups[0]))
    return _index_groups[key]


def _group_of(axis: Axis, axis_index_groups=None):
    """``(group, size)`` of ``axis``, or of this rank's part of
    ``axis_index_groups`` along it."""
    if axis_index_groups is None:
        return _resolve(axis)
    if not isinstance(axis, str):
        raise ValueError("axis_index_groups split one mesh axis")
    return index_group(axis, axis_index_groups)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def all_reduce(x: torch.Tensor, axis: Axis = None, op: str = ReduceOp.SUM,
               *, axis_index_groups=None, log_name: Optional[str] = None,
               level: Optional[str] = None):
    """``x`` reduced over ``axis``, in place (JAX :64)."""
    group, world = _group_of(axis, axis_index_groups)
    comms_logger.append("all_reduce", x, axis, log_name=log_name,
                        world=world, level=level)
    dist.all_reduce(x, op=_TORCH_OPS[op], group=group)
    if op == ReduceOp.AVG:
        x.div_(world)
    return x


def all_gather(x: torch.Tensor, axis: Axis = None, gather_dim: int = 0,
               tiled: bool = True, out: Optional[torch.Tensor] = None, *,
               axis_index_groups=None, log_name: Optional[str] = None,
               level: Optional[str] = None):
    """Every rank's ``x`` concatenated along ``gather_dim`` (``tiled``) or
    stacked on a new leading dimension (JAX :83). ``out`` (contiguous, of
    the gathered shape along dim 0) may hold ``x`` at this rank's place:
    the gather is then in place."""
    group, world = _group_of(axis, axis_index_groups)
    comms_logger.append("all_gather", x, axis, log_name=log_name,
                        world=world, level=level)
    flat_shape = (world * x.shape[0],) + tuple(x.shape[1:])
    if out is None:
        out = x.new_empty(flat_shape)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    if not tiled:
        return out.view((world,) + tuple(x.shape))
    if gather_dim % max(x.dim(), 1) != 0:
        return torch.cat(out.chunk(world), dim=gather_dim)
    return out


def reduce_scatter(x: torch.Tensor, axis: Axis = None, scatter_dim: int = 0,
                   out: Optional[torch.Tensor] = None, *,
                   axis_index_groups=None, log_name: Optional[str] = None,
                   level: Optional[str] = None):
    """The sum of every rank's ``x``, split along dim 0, this rank's block
    written to ``out`` (JAX :90, ``psum_scatter(tiled=True)``)."""
    if scatter_dim != 0:
        raise ValueError("reduce_scatter splits dim 0 (the flat buffers)")
    group, world = _group_of(axis, axis_index_groups)
    if x.shape[0] % world:
        raise ValueError(f"reduce_scatter of {x.shape[0]} rows over "
                         f"{world} ranks")
    comms_logger.append("reduce_scatter", x, axis, log_name=log_name,
                        world=world, level=level)
    if out is None:
        out = x.new_empty((x.shape[0] // world,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def broadcast(x: torch.Tensor, axis: Axis = None, root: int = 0):
    """Root's ``x`` on every rank of ``axis``, in place (JAX :122); ``root``
    is the rank's index within the axis."""
    group, world = _resolve(axis)
    comms_logger.append("broadcast", x, axis, world=world)
    src = root if group is dist.group.WORLD else dist.get_global_rank(group,
                                                                      root)
    dist.broadcast(x, src=src, group=group)
    return x


def axis_index(axis: str) -> int:
    """This rank's coordinate on ``axis`` (JAX :130)."""
    return get_default_topology().axis_index(axis)


def all_to_all_single(x: torch.Tensor, axis: Axis, split_dim: int = 0,
                      concat_dim: int = 0, *, axis_index_groups=None,
                      log_name: Optional[str] = None,
                      level: Optional[str] = None) -> torch.Tensor:
    """JAX :97 (``lax.all_to_all(tiled=True)``): ``x`` split into ``w``
    equal blocks along ``split_dim``, block j sent to the axis's rank j,
    and the ``w`` blocks received concatenated along ``concat_dim`` in rank
    order (a new tensor). Over the data axes; tp, pp, ep and sp raise
    (ROADMAP A.9)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis or ())
    unported = [a for a in axes if a not in ("dp", "fsdp")]
    if unported:
        raise NotImplementedError(
            f"all_to_all_single over {unported} waits for the other mesh "
            "axes (ROADMAP A.9)")
    group, world = _group_of(axis, axis_index_groups)
    split_dim %= x.dim()
    if x.shape[split_dim] % world:
        raise ValueError(f"all_to_all_single of {x.shape[split_dim]} rows "
                         f"along dim {split_dim} over {world} ranks")
    comms_logger.append("all_to_all", x, axis, log_name=log_name,
                        world=world, level=level)
    # [w, block]: block j goes to rank j, row i of ``out`` came from rank i
    blocks = (x.reshape((world, -1) + tuple(x.shape[1:])) if split_dim == 0
              else torch.stack(x.chunk(world, split_dim)))
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks.contiguous(), group=group)
    if concat_dim % x.dim() == 0:
        return out.reshape((-1,) + tuple(out.shape[2:]))
    return torch.cat(out.unbind(0), dim=concat_dim)


def ppermute(x, axis: str, perm):
    raise NotImplementedError(
        "ppermute waits for the pipeline and sequence axes (ROADMAP A.9)")


def send_recv_next(x, axis: str, axis_size: int):
    return ppermute(x, axis, None)


def send_recv_prev(x, axis: str, axis_size: int):
    return ppermute(x, axis, None)


def warm_up(axes: Sequence[Axis], device, index_groups=()) -> None:
    """One small all-reduce and all-to-all on each group of ``axes`` and on
    this rank's group of each ``(axis, groups)`` in ``index_groups`` (made
    here if new), so that NCCL makes its communicators and connections now
    and not inside a CUDA graph capture. Not logged."""
    groups = [_resolve(axis) for axis in axes]
    groups += [index_group(axis, g) for axis, g in index_groups]
    for group, world in groups:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
        x = torch.zeros(world, dtype=torch.int8, device=device)
        dist.all_to_all_single(torch.empty_like(x), x, group=group)


# ---------------------------------------------------------------------------
# process management
# ---------------------------------------------------------------------------
def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def init_distributed(dist_backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     timeout: Optional[timedelta] = None,
                     device_type: Optional[str] = None) -> None:
    """Initialise the default process group once (later calls return).

    ``device_type`` "cuda" (the default) takes NCCL and one card per rank,
    ``torch.cuda.set_device(local_rank)``, and raises when torch sees no
    card; "cpu" takes gloo. ``rank``, ``world_size`` and ``local_rank``
    default to torchrun's ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``;
    ``init_method`` to ``env://`` when ``MASTER_ADDR`` is set. With neither
    an ``init_method`` nor ``MASTER_ADDR``, the group is one rank on an
    in-memory store (a larger world raises). A failed rendezvous raises
    (after ``timeout``)."""
    global _local_rank
    if is_initialized():
        return
    rank = rank if rank is not None else _env_int("RANK")
    world_size = world_size if world_size is not None else _env_int("WORLD_SIZE")
    local_rank = (local_rank if local_rank is not None
                  else _env_int("LOCAL_RANK"))
    if device_type is None:
        device_type = "cuda"
    if dist_backend is None:
        dist_backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed runs one CUDA card per rank by default and "
                "torch sees none; pass device_type='cpu' for gloo on the host")
        if local_rank is None:
            local_rank = (rank or 0) % torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
    _local_rank = local_rank or 0
    kwargs = {} if timeout is None else {"timeout": timeout}
    if init_method is None and "MASTER_ADDR" not in os.environ:
        if (world_size or 1) != 1:
            raise ValueError(
                f"init_distributed: a world of {world_size} needs an "
                "init_method or torchrun's MASTER_ADDR/MASTER_PORT")
        kwargs["store"] = dist.HashStore()
        rank, world_size = 0, 1
    elif init_method is None:
        init_method = "env://"
    if init_method is not None:
        kwargs["init_method"] = init_method
    logger.info(f"init_distributed: backend={dist_backend} rank={rank} "
                f"world_size={world_size} local_rank={_local_rank} "
                f"init_method={init_method or 'in-memory store'}")
    dist.init_process_group(dist_backend, rank=rank, world_size=world_size,
                            **kwargs)
    log_dist(f"process group ready: {dist.get_world_size()} ranks, backend "
             f"{dist_backend}", ranks=[0])


def destroy_distributed() -> None:
    """Tear the default process group down (and the default topology)."""
    from deepspeed_tpu_torch.parallel.mesh import reset_default_topology

    if is_initialized():
        dist.destroy_process_group()
    _index_groups.clear()
    reset_default_topology()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_backend() -> Optional[str]:
    return dist.get_backend() if is_initialized() else None


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_local_rank() -> int:
    if _local_rank is not None:
        return _local_rank
    return _env_int("LOCAL_RANK") or 0


def get_local_device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def barrier() -> None:
    """Every rank waits for every other (no-op without a group)."""
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_gather_object(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order: a collective on the
    host's side, outside any captured step (``[obj]`` without a group)."""
    if not is_initialized():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def log_summary():
    return comms_logger.log_summary()
