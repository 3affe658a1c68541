"""The device mesh over ranks (counterpart of
``deepspeed_tpu/parallel/mesh.py``: ``MeshTopology`` :37, the default
registry and ``topology_from_config`` :257-291).

The JAX package lays ONE ``jax.sharding.Mesh`` with named axes over its
devices; the port lays the same named axes over the ranks of the process
group, one card per rank, with ``torch.distributed.device_mesh
.init_device_mesh`` (``AXIS_ORDER``'s names), and an axis name resolves to
that mesh dimension's process group (``group(axis)``). The axes and their
order are the JAX package's:

* ``pp``   pipeline stages
* ``dp``   pure data parallel (replicated parameters)
* ``fsdp`` sharded data parallel: ZeRO 1-2 partition over it
* ``ep``   expert parallel
* ``sp``   sequence parallel
* ``tp``   tensor parallel (innermost)

The global batch is split over (dp, fsdp, ep). The size and coordinate
queries are pure and need no process group (a mesh over ``world_size``
ranks), so they can be held against the JAX class on the virtual CPU
devices; ``device_mesh`` and ``group`` need an initialised group of
``num_devices`` ranks. dp, fsdp, ep and tp may exceed 1 in the port; pp
and sp wait for ROADMAP A.9 parts 2-3 (the engine refuses them).

``group`` takes one axis (that mesh dimension's group) or a tuple of axes:
the group of the ranks that differ only on those axes, made with
``new_group`` for every such slice in one order on every rank. Two such
groups the engines use have names: ``EXPERT_DATA_AXES`` (dp, fsdp: the
ranks that share a tp and an ep coordinate; expert leaves reduce their
gradients over it) and ``BATCH_AXES`` (dp, fsdp, ep: every rank that takes
its own rows; every other leaf reduces over it).
"""

import math
from typing import Dict, List, Optional, Tuple

AXIS_ORDER: Tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")
BATCH_AXES: Tuple[str, ...] = ("dp", "fsdp", "ep")
EXPERT_DATA_AXES: Tuple[str, ...] = ("dp", "fsdp")


# (mesh shape, axis or axes) -> process group, and mesh shape -> DeviceMesh:
# shared by every MeshTopology of one shape, so engines built one after
# another reuse their groups (and NCCL its communicators); cleared by
# comm.destroy_distributed
_MESHES: Dict[Tuple[int, ...], object] = {}
_GROUPS: Dict[tuple, object] = {}


def clear_group_cache() -> None:
    _MESHES.clear()
    _GROUPS.clear()


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class MeshTopology:
    """Named-axis mesh over ``world_size`` ranks (default: the process
    group's size, or 1 without a group), row-major in ``AXIS_ORDER``: rank
    r sits at ``coord_of(r)``. At most one axis may be -1 (the ranks left
    over)."""

    def __init__(self, dp: int = -1, fsdp: int = 1, tp: int = 1, pp: int = 1,
                 ep: int = 1, sp: int = 1, world_size: Optional[int] = None):
        if world_size is None:
            dist = _dist()
            world_size = dist.get_world_size() if dist is not None else 1
        n = int(world_size)
        sizes: Dict[str, int] = {
            "pp": pp, "dp": dp, "fsdp": fsdp, "ep": ep, "sp": sp, "tp": tp}
        bad = {a: s for a, s in sizes.items() if s != -1 and s < 1}
        if bad:
            raise ValueError(
                f"Mesh axis sizes must be >= 1 (or -1 to infer): {bad}")
        unknown = [a for a, s in sizes.items() if s == -1]
        if len(unknown) > 1:
            raise ValueError(f"At most one mesh axis may be -1, got {unknown}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if unknown:
            if n % fixed != 0:
                raise ValueError(
                    f"{n} devices not divisible by fixed axes product {fixed}")
            sizes[unknown[0]] = n // fixed
        total = math.prod(sizes.values())
        if total != n:
            raise ValueError(f"Mesh axes {sizes} require {total} devices but "
                             f"{n} are available")
        self.axis_sizes = sizes

    # -- size queries -------------------------------------------------------
    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.axis_sizes[a] for a in AXIS_ORDER)

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes.values())

    @property
    def data_parallel_size(self) -> int:
        """Number of distinct data shards = dp * fsdp * ep."""
        return math.prod(self.axis_sizes[a] for a in BATCH_AXES)

    @property
    def model_parallel_size(self) -> int:
        return self.axis_sizes["tp"]

    @property
    def pipe_parallel_size(self) -> int:
        return self.axis_sizes["pp"]

    @property
    def expert_parallel_size(self) -> int:
        return self.axis_sizes["ep"]

    @property
    def sequence_parallel_size(self) -> int:
        return self.axis_sizes["sp"]

    def active_axes(self) -> List[str]:
        return [a for a in AXIS_ORDER if self.axis_sizes[a] > 1]

    # -- coordinate queries ---------------------------------------------------
    def coord_of(self, flat_rank: int) -> Dict[str, int]:
        """Coordinates of rank ``flat_rank`` (row-major in AXIS_ORDER)."""
        if not 0 <= flat_rank < self.num_devices:
            raise ValueError(f"rank {flat_rank} outside a mesh of "
                             f"{self.num_devices}")
        coords = {}
        for axis in reversed(AXIS_ORDER):
            flat_rank, coords[axis] = divmod(flat_rank, self.axis_sizes[axis])
        return {a: coords[a] for a in AXIS_ORDER}

    def filter_ranks(self, **axis_values) -> List[int]:
        """Every rank whose coordinates match the given axis values."""
        return [r for r in range(self.num_devices)
                if all(self.coord_of(r)[a] == v
                       for a, v in axis_values.items())]

    def batch_spec(self) -> Optional[Tuple[str, ...]]:
        """The axes the global batch is split over (the JAX
        ``PartitionSpec``'s first entry): the batch axes of size > 1, or
        None when the batch is not split."""
        axes = tuple(a for a in BATCH_AXES if self.axis_sizes[a] > 1)
        return axes or None

    def data_parallel_rank(self, rank: Optional[int] = None) -> int:
        """Which slice of the global batch ``rank`` (default: this
        process's) takes: its row-major index over the batch axes."""
        c = self.coord_of(self.rank if rank is None else rank)
        index = 0
        for axis in BATCH_AXES:
            index = index * self.axis_sizes[axis] + c[axis]
        return index

    # -- the process groups ---------------------------------------------------
    @property
    def rank(self) -> int:
        dist = _dist()
        return dist.get_rank() if dist is not None else 0

    def axis_index(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        return self.coord_of(self.rank)[axis]

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over the process group, made at first use."""
        if self.shape not in _MESHES:
            dist = _dist()
            if dist is None:
                raise RuntimeError("MeshTopology.device_mesh needs an "
                                   "initialised process group "
                                   "(comm.init_distributed)")
            if dist.get_world_size() != self.num_devices:
                raise ValueError(
                    f"a mesh of {self.num_devices} ranks over a process "
                    f"group of {dist.get_world_size()}")
            from torch.distributed.device_mesh import init_device_mesh

            device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
            _MESHES[self.shape] = init_device_mesh(
                device_type, self.shape, mesh_dim_names=AXIS_ORDER)
        return _MESHES[self.shape]

    def group(self, axis):
        """The process group of this rank's slice along ``axis``, or along
        several axes (a tuple): the ranks whose other coordinates equal
        this rank's. A tuple's groups are made at its first use, for every
        slice, in one order (``new_group`` is a collective of the whole
        world: every rank must ask for the same tuples in the same
        order)."""
        key = axis if isinstance(axis, str) else tuple(
            a for a in AXIS_ORDER if a in tuple(axis))
        if (self.shape, key) not in _GROUPS:
            _GROUPS[self.shape, key] = (
                self.device_mesh.get_group(key) if isinstance(key, str)
                else self._slice_group(key))
        return _GROUPS[self.shape, key]

    def _slice_group(self, axes: Tuple[str, ...]):
        dist = _dist()
        if dist is None:
            raise RuntimeError("MeshTopology.group needs an initialised "
                               "process group (comm.init_distributed)")
        self.device_mesh  # the same checks as a single axis
        others = [a for a in AXIS_ORDER if a not in axes]
        me, mine, seen = dist.get_rank(), None, set()
        for r in range(self.num_devices):
            c = self.coord_of(r)
            fixed = tuple(c[a] for a in others)
            if fixed in seen:
                continue
            seen.add(fixed)
            ranks = self.filter_ranks(**{a: c[a] for a in others})
            g = dist.new_group(ranks)
            if me in ranks:
                mine = g
        return mine

    def __repr__(self):
        active = {a: s for a, s in self.axis_sizes.items() if s > 1}
        return (f"MeshTopology({active or 'single-device'}, "
                f"devices={self.num_devices})")


_DEFAULT_TOPOLOGY: Optional[MeshTopology] = None


def set_default_topology(topo: MeshTopology) -> None:
    global _DEFAULT_TOPOLOGY
    _DEFAULT_TOPOLOGY = topo


def get_default_topology() -> MeshTopology:
    """The registered topology, or a pure data-parallel one over the
    process group (dp = the world)."""
    global _DEFAULT_TOPOLOGY
    if _DEFAULT_TOPOLOGY is None:
        _DEFAULT_TOPOLOGY = MeshTopology()
    return _DEFAULT_TOPOLOGY


def reset_default_topology() -> None:
    global _DEFAULT_TOPOLOGY
    _DEFAULT_TOPOLOGY = None


def topology_from_config(mesh_config, world_size: Optional[int] = None
                         ) -> MeshTopology:
    """A MeshTopology from a config ``MeshConfig`` or dict."""
    if hasattr(mesh_config, "to_dict"):
        mesh_config = mesh_config.to_dict()
    mesh_config = dict(mesh_config or {})
    return MeshTopology(
        dp=mesh_config.get("dp", -1), fsdp=mesh_config.get("fsdp", 1),
        tp=mesh_config.get("tp", 1), pp=mesh_config.get("pp", 1),
        ep=mesh_config.get("ep", 1), sp=mesh_config.get("sp", 1),
        world_size=world_size)
