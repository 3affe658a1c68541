"""The port's communication layer, mesh and layout against the JAX
package's.

* The collectives of ``deepspeed_tpu_torch.comm`` on 2 gloo ranks (child
  processes, ``python tests/test_torch_comm.py --worker ...``, torch only;
  a ``file://`` rendezvous under the test's temporary directory, a 60 s
  group timeout and a 120 s process timeout), against the values numpy
  gives for the same inputs; the comms logger's counters of that run
  against the JAX ``CommsLogger`` fed the same ops, sizes and worlds.
* ``all_to_all_single`` and collectives over ``axis_index_groups`` on the
  same 2 ranks.
* ``wire_factor`` and ``CommsLogger`` in one process, against the JAX
  module.
* ``MeshTopology`` and the ``layout`` helpers against the JAX classes on
  the virtual CPU devices, for (dp, fsdp) in {(2, 1), (1, 2), (2, 2)}.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
CHILD_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
# (op, number of elements, dtype) of every collective the worker logs, in
# order (the inputs of ``_collectives``)
LOGGED = [("all_reduce", 6, "float32"), ("all_reduce", 6, "float32"),
          ("all_reduce", 6, "float32"), ("all_gather", 3, "float32"),
          ("all_gather", 3, "float32"), ("reduce_scatter", 8, "bfloat16"),
          ("broadcast", 5, "float32"), ("all_reduce", 1, "float32")]


def _collectives(rank):
    """Every collective of the worker, in the order of ``LOGGED``; returns
    their results as numpy arrays."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime.utils import get_global_norm

    x = torch.arange(6, dtype=torch.float32) + 10 * rank
    out = {"sum": comm.all_reduce(x.clone(), "fsdp"),
           "avg": comm.all_reduce(x.clone(), "fsdp", comm.ReduceOp.AVG),
           "max": comm.all_reduce(x.clone(), ("dp", "fsdp"),
                                  comm.ReduceOp.MAX)}
    shard = torch.full((3,), float(rank + 1))
    out["gather"] = comm.all_gather(shard, "fsdp")
    flat = torch.zeros(3 * WORLD)
    mine = flat[3 * rank:3 * (rank + 1)]
    mine.fill_(rank + 1)
    comm.all_gather(mine, "fsdp", out=flat)  # in place
    out["gather_in_place"] = flat
    full = torch.arange(8, dtype=torch.bfloat16) * (rank + 1)
    out["scatter"] = comm.reduce_scatter(full, "fsdp").float()
    out["bcast"] = comm.broadcast(torch.full((5,), float(rank)), "fsdp",
                                  root=1)
    out["norm"] = get_global_norm([torch.tensor([3.0 * (rank + 1)])],
                                  axis="fsdp")
    out["axis_index"] = torch.tensor(comm.axis_index("fsdp"))
    return {k: v.numpy() for k, v in out.items()}


def _all_to_all_and_groups(rank):
    """``all_to_all_single`` (dim 0, other dims, int8) and collectives over
    ``axis_index_groups`` of the fsdp axis (after the logged collectives:
    they are not in ``LOGGED``)."""
    from deepspeed_tpu_torch import comm

    out = {}
    x = torch.arange(8, dtype=torch.float32) + 100 * rank
    out["a2a"] = comm.all_to_all_single(x, "fsdp")
    m = (torch.arange(12, dtype=torch.float32) + 100 * rank).view(3, 4)
    out["a2a_split1_concat0"] = comm.all_to_all_single(m, "fsdp", 1, 0)
    out["a2a_split0_concat1"] = comm.all_to_all_single(
        torch.arange(8, dtype=torch.float32).view(4, 2) + 100 * rank,
        "fsdp", 0, 1)
    out["a2a_int8"] = comm.all_to_all_single(
        torch.tensor([rank, -rank, 3, -3], dtype=torch.int8), "fsdp").int()
    y = torch.full((3,), float(rank + 1))
    out["alone"] = comm.all_reduce(y.clone(), "fsdp",
                                   axis_index_groups=[[0], [1]])
    out["together"] = comm.all_reduce(y.clone(), "fsdp",
                                      axis_index_groups=[[0, 1]])
    out["gather_alone"] = comm.all_gather(y, "fsdp",
                                          axis_index_groups=[[0], [1]])
    out["group_size"] = torch.tensor(
        comm.index_group("fsdp", [[0], [1]])[1])
    for key, call in (
            ("a2a_tp", lambda: comm.all_to_all_single(x, "tp")),
            ("unequal", lambda: comm.all_reduce(
                y.clone(), "fsdp", axis_index_groups=[[0, 1], []]))):
        try:
            call()
        except (NotImplementedError, ValueError) as e:
            out[key] = str(e)
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in out.items()}


def _worker(argv):
    rank, world, url, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    from datetime import timedelta

    import torch.distributed as dist

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import (MeshTopology,
                                                   set_default_topology)

    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          timeout=timedelta(seconds=GROUP_TIMEOUT_S),
                          device_type="cpu")
    set_default_topology(MeshTopology(dp=1, fsdp=world))
    comm.comms_logger.enabled = True
    results = _collectives(rank)
    results["counters"] = comm.comms_logger.counters()
    results.update(_all_to_all_and_groups(rank))
    try:
        comm.ppermute(torch.zeros(1), "fsdp", [(0, 1), (1, 0)])
    except NotImplementedError as e:
        results["ppermute"] = str(e)
    # the DeviceMesh's groups: fsdp spans both ranks, dp is this rank alone
    topo = MeshTopology(dp=1, fsdp=world)
    results["groups"] = {a: dist.get_process_group_ranks(topo.group(a))
                         for a in ("dp", "fsdp")}
    torch.save(results, out)
    comm.destroy_distributed()
    return 0


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("comm"))
    rdv = os.path.join(tmp, "rendezvous")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(WORLD), f"file://{rdv}", outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1")) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


def test_collectives_on_two_ranks(two_ranks):
    x = [np.arange(6, dtype=np.float32) + 10 * r for r in range(WORLD)]
    for rank, got in enumerate(two_ranks):
        np.testing.assert_array_equal(got["sum"], x[0] + x[1])
        np.testing.assert_array_equal(got["avg"], (x[0] + x[1]) / 2)
        np.testing.assert_array_equal(got["max"], np.maximum(x[0], x[1]))
        want = np.repeat([1.0, 2.0], 3)
        np.testing.assert_array_equal(got["gather"], want)
        np.testing.assert_array_equal(got["gather_in_place"], want)
        full = np.arange(8, dtype=np.float32) * 3  # rank 0's + rank 1's
        np.testing.assert_array_equal(got["scatter"],
                                      full[4 * rank:4 * (rank + 1)])
        np.testing.assert_array_equal(got["bcast"], np.ones(5))
        np.testing.assert_allclose(got["norm"], np.sqrt(3.0 ** 2 + 6.0 ** 2),
                                   rtol=1e-6)
        assert int(got["axis_index"]) == rank
        assert "ROADMAP A.9" in got["ppermute"]
        assert got["groups"] == {"dp": [rank], "fsdp": [0, 1]}


def test_all_to_all_and_sub_groups(two_ranks):
    """``all_to_all_single`` against ``lax.all_to_all(tiled=True)``'s
    semantics on the same inputs (block j of rank i lands in row block i of
    rank j), and collectives within ``axis_index_groups``."""
    x = [np.arange(8, dtype=np.float32) + 100 * r for r in range(WORLD)]
    m = [(np.arange(12, dtype=np.float32) + 100 * r).reshape(3, 4)
         for r in range(WORLD)]
    v = [np.arange(8, dtype=np.float32).reshape(4, 2) + 100 * r
         for r in range(WORLD)]
    for rank, got in enumerate(two_ranks):
        np.testing.assert_array_equal(
            got["a2a"], np.concatenate([x[r][4 * rank:4 * rank + 4]
                                        for r in range(WORLD)]))
        np.testing.assert_array_equal(
            got["a2a_split1_concat0"],
            np.concatenate([m[r][:, 2 * rank:2 * rank + 2]
                            for r in range(WORLD)], axis=0))
        np.testing.assert_array_equal(
            got["a2a_split0_concat1"],
            np.concatenate([v[r][2 * rank:2 * rank + 2]
                            for r in range(WORLD)], axis=1))
        # rank r sends [r, -r] to rank 0 and [3, -3] to rank 1
        np.testing.assert_array_equal(
            got["a2a_int8"], [0, 0, 1, -1] if rank == 0 else [3, -3, 3, -3])
        np.testing.assert_array_equal(got["alone"], np.full(3, rank + 1.0))
        np.testing.assert_array_equal(got["together"], np.full(3, 3.0))
        np.testing.assert_array_equal(got["gather_alone"],
                                      np.full(3, rank + 1.0))
        assert int(got["group_size"]) == 1
        assert "ROADMAP A.9" in got["a2a_tp"]
        assert "equal-size" in got["unequal"]


def test_logged_counters_match_jax(two_ranks):
    """The worker's counters against the JAX logger fed the same ops, at
    axis size 2."""
    import ml_dtypes

    from deepspeed_tpu.comm.logging import CommsLogger as JaxCommsLogger

    jlog = JaxCommsLogger(enabled=True)
    for op, n, dtype in LOGGED:
        dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
        jlog.append(op, np.zeros(n, dt), "fsdp", world=WORLD)
    for got in two_ranks:
        assert got["counters"] == jlog.counters()


@pytest.mark.parametrize("op", ["all_reduce", "all_gather", "reduce_scatter",
                                "broadcast", "all_to_all", "ppermute",
                                "all_reduce.grads"])
@pytest.mark.parametrize("world", [None, 1, 2, 4, 8])
def test_wire_factor_matches_jax(op, world):
    from deepspeed_tpu.comm.logging import wire_factor as jax_wire_factor
    from deepspeed_tpu_torch.comm.logging import wire_factor

    assert wire_factor(op, world) == jax_wire_factor(op, world)


def test_comms_logger_matches_jax():
    """The same records through both loggers: counts, payload and wire
    bytes (in another wire dtype too), message sizes, the summary."""
    import ml_dtypes

    from deepspeed_tpu.comm.logging import CommsLogger as JaxCommsLogger
    from deepspeed_tpu_torch.comm.logging import CommsLogger

    jlog, tlog = JaxCommsLogger(enabled=True), CommsLogger(enabled=True)
    for op, n, world, wire in [("all_reduce", 10, 4, None),
                               ("all_gather", 7, 2, None),
                               ("reduce_scatter", 12, 4, "bfloat16"),
                               ("all_reduce", 10, 4, None),
                               ("broadcast", 3, None, None)]:
        jlog.append(op, np.zeros(n, np.float32), "fsdp", world=world,
                    wire_dtype=None if wire is None else ml_dtypes.bfloat16)
        tlog.append(op, torch.zeros(n), "fsdp", world=world,
                    wire_dtype=None if wire is None else torch.bfloat16)
    assert tlog.counters() == jlog.counters()
    assert tlog.total_wire_bytes() == jlog.total_wire_bytes()
    for name, rec in jlog.comms_dict.items():
        mine = tlog.comms_dict[name]
        assert dict(mine["msg_sizes"]) == dict(rec["msg_sizes"])
        assert mine["wire_dtype"] == rec["wire_dtype"]
    assert tlog.log_summary() == jlog.log_summary()
    disabled = CommsLogger()
    disabled.append("all_reduce", torch.zeros(4), "dp", world=2)
    assert disabled.counters()["total_wire_bytes"] == 0.0


def test_capture_records_add_back():
    """``since`` / ``add``: what a capture recorded, taken back and added
    once per replay, leaves the counters as the executed ops give them."""
    from deepspeed_tpu_torch.comm.logging import CommsLogger

    log = CommsLogger(enabled=True)
    log.append("all_reduce", torch.zeros(4), "dp", world=2)
    before = log.snapshot()
    log.append("reduce_scatter", torch.zeros(8), "fsdp", world=2)
    log.append("all_reduce", torch.zeros(2), "dp", world=2)
    seen = log.since(before)
    log.add(seen, sign=-1)
    assert log.counters() == _counters_after([("all_reduce", 4)])
    for _ in range(3):
        log.add(seen)
    assert log.counters() == _counters_after(
        [("all_reduce", 4)] + 3 * [("reduce_scatter", 8), ("all_reduce", 2)])


def test_capture_records_keep_levels():
    """A capture's records tagged "ici"/"dcn" (the hierarchical exchange)
    move the per-level bytes out at the capture and back once per
    replay."""
    from deepspeed_tpu_torch.comm.logging import CommsLogger

    log = CommsLogger(enabled=True)
    before = log.snapshot()
    log.append("reduce_scatter", torch.zeros(8), "dp", log_name="h.ici",
               world=2, level="ici")
    log.append("all_to_all", torch.zeros(8, dtype=torch.int8), "dp",
               log_name="h.dcn", world=2, level="dcn")
    seen = log.since(before)
    log.add(seen, sign=-1)
    assert log.counters()["ici_bytes"] == log.counters()["dcn_bytes"] == 0
    for _ in range(2):
        log.add(seen)
    assert log.counters()["ici_bytes"] == 2 * 16.0   # 32 B x (w-1)/w
    assert log.counters()["dcn_bytes"] == 2 * 4.0    # 8 B x (w-1)/w


def _counters_after(ops):
    from deepspeed_tpu_torch.comm.logging import CommsLogger

    log = CommsLogger(enabled=True)
    for op, n in ops:
        log.append(op, torch.zeros(n), "x", world=2)
    return log.counters()


MESHES = [(2, 1), (1, 2), (2, 2)]


def _both(dp, fsdp):
    import jax

    from deepspeed_tpu.parallel.mesh import MeshTopology as JaxMesh
    from deepspeed_tpu_torch.parallel.mesh import MeshTopology

    n = dp * fsdp
    return (MeshTopology(dp=dp, fsdp=fsdp, world_size=n),
            JaxMesh(dp=dp, fsdp=fsdp, devices=jax.devices()[:n]))


@pytest.mark.parametrize("dp,fsdp", MESHES)
def test_mesh_queries_match_jax(dp, fsdp):
    mine, ref = _both(dp, fsdp)
    assert mine.axis_sizes == ref.axis_sizes
    for attr in ("num_devices", "data_parallel_size", "model_parallel_size",
                 "pipe_parallel_size", "expert_parallel_size",
                 "sequence_parallel_size"):
        assert getattr(mine, attr) == getattr(ref, attr), attr
    assert mine.active_axes() == ref.active_axes()
    for r in range(mine.num_devices):
        assert mine.coord_of(r) == ref.coord_of(r)
    for axis in ("dp", "fsdp"):
        for v in range(mine.size(axis)):
            assert (mine.filter_ranks(**{axis: v})
                    == ref.filter_ranks(**{axis: v}))
    want = ref.batch_spec()[0]  # one axis reads as its name
    assert mine.batch_spec() == ((want,) if isinstance(want, str) else want)
    # the data-parallel rank of each position: its row of the global batch
    assert sorted(mine.data_parallel_rank(r)
                  for r in range(mine.num_devices)) == list(range(dp * fsdp))


@pytest.mark.parametrize("dp,fsdp", MESHES)
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_layout_matches_jax(dp, fsdp, stage):
    from deepspeed_tpu.runtime import layout as jlayout
    from deepspeed_tpu_torch.runtime import layout

    mine, ref = _both(dp, fsdp)
    mine, ref = (layout.apply_zero_fsdp_move(mine, stage),
                 jlayout.apply_zero_fsdp_move(ref, stage))
    assert mine.axis_sizes == ref.axis_sizes
    block = layout.topology_metadata(mine, stage)
    assert block == jlayout.topology_metadata(ref, stage)
    for other_dp, other_fsdp in MESHES + [(1, 1)]:
        other_mine, other_ref = _both(other_dp, other_fsdp)
        for other_stage in (stage, 3 - stage):
            assert (layout.topology_matches(block, other_mine, other_stage)
                    == jlayout.topology_matches(block, other_ref,
                                                other_stage))


@pytest.mark.parametrize("dp,fsdp", MESHES)
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_fsdp_move_with_compression_matches_jax(dp, fsdp, stage):
    """``apply_zero_fsdp_move(compressed=True)``: a compressed exchange
    keeps the data parallelism on dp (1-bit Adam at stage 1)."""
    from deepspeed_tpu.runtime import layout as jlayout
    from deepspeed_tpu_torch.runtime import layout

    mine, ref = _both(dp, fsdp)
    for compressed in (False, True):
        assert (layout.apply_zero_fsdp_move(mine, stage, compressed)
                .axis_sizes == jlayout.apply_zero_fsdp_move(
                    ref, stage, compressed=compressed).axis_sizes)


def test_zero_rules_and_flat_partition():
    """The stage rules (what each stage partitions) and the flat layout:
    leaves at ALIGN, shards of equal size covering the padded buffer."""
    from deepspeed_tpu_torch.parallel.mesh import MeshTopology
    from deepspeed_tpu_torch.runtime.zero.sharding import (
        ALIGN, FlatPartition, ZeroShardingRules)

    topo = MeshTopology(dp=1, fsdp=4, world_size=4)
    shape = (10, 7)
    got = {s: (ZeroShardingRules(topo, s).param_spec("w", shape),
               ZeroShardingRules(topo, s).grad_accum_spec("w", shape),
               ZeroShardingRules(topo, s).opt_state_spec("w", shape))
           for s in range(4)}
    assert got == {0: ((), (), ()), 1: ((), (), ("fsdp",)),
                   2: ((), ("fsdp",), ("fsdp",)),
                   3: (("fsdp",), ("fsdp",), ("fsdp",))}
    # stage 3 keeps a leaf under the persistence threshold whole (the flat
    # layout partitions a leaf whatever its dimensions, where the JAX
    # package needs one that the axis divides)
    keep = ZeroShardingRules(topo, 3, param_persistence_threshold=71)
    assert keep.param_spec("w", shape) == ()
    assert keep.partitions_param((71,)) and not keep.partitions_param(shape)
    named = [("a", torch.zeros(10, 7)), ("b", torch.zeros(3)),
             ("c", torch.zeros(5, dtype=torch.bfloat16)),
             ("d", torch.zeros(130))]
    part = FlatPartition(named, world=4, rank=2)
    f32, bf16 = part.groups
    assert f32.names == ["a", "b", "d"] and bf16.names == ["c"]
    assert f32.offsets == [0, 128, 192] and f32.numel == 384
    assert all(o % ALIGN == 0 for o in f32.offsets)
    assert f32.padded % (4 * ALIGN) == 0 and f32.shard_size * 4 == f32.padded
    covered = [x for r in range(4) for x in f32.shard_overlaps(r)]
    per_leaf = {}
    for leaf, a, b in covered:
        per_leaf[leaf] = per_leaf.get(leaf, 0) + b - a
    assert per_leaf == {0: 70, 1: 3, 2: 130}
    runs = f32.shard_runs()
    got = torch.cat([torch.full((b - a,), leaf) for leaf, a, b in runs])
    expect = torch.full((f32.shard_size,), 3)
    for leaf, a, b in f32.shard_overlaps(2):
        expect[a - f32.start:b - f32.start] = leaf
    assert torch.equal(got, expect)
    flats = part.flatten(named)
    assert named[0][1].data_ptr() == flats[0].data_ptr()
    assert named[3][1].data_ptr() == flats[0][192:].data_ptr()


def test_zero_api_surface():
    """``zero.Init`` is a documented no-op; ``GatheredParameters`` holds
    whole host copies of the parameters it is given."""
    from deepspeed_tpu_torch.runtime import zero

    with zero.Init(remote_device="cpu", config_dict_or_path={"a": 1}) as init:
        assert init.enabled and init.remote_device == "cpu"
    params = {"w": torch.arange(4.0), "b": [torch.ones(2)]}
    with zero.GatheredParameters(params) as gathered:
        got = gathered.params
    assert torch.equal(got["w"], params["w"]) and got["w"] is not params["w"]
    assert torch.equal(got["b"][0], params["b"][0])
    with zero.GatheredParameters(params, enabled=False) as gathered:
        assert gathered.params is params


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(sys.argv[2:]))
