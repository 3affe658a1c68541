"""Mesh construction and the state layout's manifest record (counterpart
of ``deepspeed_tpu/runtime/layout.py``: ``build_topology`` :38,
``apply_zero_fsdp_move`` :47, ``build_sharding_rules`` :72,
``topology_metadata`` :138 and ``topology_matches`` :155).

The same decisions as the JAX engine: the mesh comes from the config, a
ZeRO stage moves the data-parallel axis to fsdp (but for a compressed
gradient exchange),
and a checkpoint's manifest carries a ``topology`` block (world size, zero
stage, axis sizes and the partition record) that a load compares with
its own to detect a reshard. ``partition_specs`` describes the port's
flat layout (``runtime/zero/sharding.py``) in the JAX record's shape:
``{"params": {name: {"spec": [...], "shape": [...]}}, "opt_state": {name:
{"spec": [...], "shape": [...]}}, "flat": [per-dtype buffer]}`` (a
parameter's spec is ``["fsdp"]`` where stage 3 partitions it).
"""

from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.parallel.mesh import (AXIS_ORDER, MeshTopology,
                                               topology_from_config)
from deepspeed_tpu_torch.runtime.zero.sharding import ZeroShardingRules
from deepspeed_tpu_torch.utils.logging import log_dist


def build_topology(config, world_size: int) -> MeshTopology:
    """The engine's initial topology: the mesh config resolved against
    ``world_size`` ranks."""
    return topology_from_config(config.tpu.mesh_config, world_size=world_size)


def apply_zero_fsdp_move(topology: MeshTopology, zero_stage: int,
                         compressed: bool = False) -> MeshTopology:
    """ZeRO partitions over the fsdp axis: when a ZeRO stage is asked for
    but all data parallelism is on ``dp``, move it to ``fsdp``. The
    compressed exchanges keep it on ``dp``: they need each worker's whole
    gradient or momentum (1-bit Adam at stage 1 keeps its state
    replicated)."""
    if (zero_stage >= 1 and topology.size("fsdp") == 1
            and topology.size("dp") > 1 and not compressed):
        sizes = dict(topology.axis_sizes)
        sizes["fsdp"] = sizes.pop("dp")
        sizes["dp"] = 1
        topology = MeshTopology(**sizes, world_size=topology.num_devices)
        log_dist(f"zero stage {zero_stage}: data-parallel axis moved to fsdp "
                 f"({topology})", ranks=[0])
    return topology


def build_sharding_rules(topology: MeshTopology, zero_stage: int,
                         param_persistence_threshold: int = 0
                         ) -> ZeroShardingRules:
    """The per-leaf layout policy for this (topology, stage) pair; the
    threshold counts only at stage 3."""
    return ZeroShardingRules(
        topology, stage=zero_stage,
        param_persistence_threshold=(
            param_persistence_threshold if zero_stage >= 3 else 0))


def describe_partition(rules: ZeroShardingRules, groups,
                       shapes: Optional[Dict[str, Any]] = None
                       ) -> Dict[str, Any]:
    """The ``partition_specs`` record of a flat partition's groups (at
    stage 3 the whole leaves' groups, then every unit's); ``shapes``: the
    leaves' whole shapes where a rank holds tp/ep shards (a tag holds
    whole tensors)."""
    params, opt = {}, {}
    for group in groups:
        for name, shape in zip(group.names, group.shapes):
            shape = (shapes or {}).get(name, shape)
            params[name] = {"spec": list(rules.param_spec(name, shape)),
                            "shape": list(shape)}
            opt[name] = {"spec": list(rules.opt_state_spec(name, shape)),
                         "shape": list(shape)}
    return {"params": params, "opt_state": opt,
            "flat": [g.describe() for g in groups]}


def topology_metadata(topology: MeshTopology, zero_stage: int,
                      partition_specs: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, Any]:
    """The manifest ``topology`` block."""
    meta: Dict[str, Any] = {
        "world_size": int(topology.num_devices),
        "zero_stage": int(zero_stage),
        "axis_sizes": {a: int(topology.axis_sizes[a]) for a in AXIS_ORDER},
    }
    if partition_specs:
        meta["partition_specs"] = partition_specs
    return meta


def topology_matches(saved: Dict[str, Any], topology: MeshTopology,
                     zero_stage: Optional[int] = None) -> List[str]:
    """The differences between a saved topology block and a live topology,
    one description each (empty: the same layout)."""
    mismatches: List[str] = []
    saved_world = saved.get("world_size")
    if saved_world is not None and int(saved_world) != topology.num_devices:
        mismatches.append(f"world_size {saved_world} -> {topology.num_devices}")
    saved_axes = saved.get("axis_sizes") or {}
    for axis in AXIS_ORDER:
        if axis not in saved_axes:
            continue
        cur = topology.axis_sizes[axis]
        if int(saved_axes[axis]) != cur:
            mismatches.append(f"{axis} {saved_axes[axis]} -> {cur}")
    if (zero_stage is not None and saved.get("zero_stage") is not None
            and int(saved["zero_stage"]) != int(zero_stage)):
        mismatches.append(f"zero_stage {saved['zero_stage']} -> {zero_stage}")
    return mismatches
