"""The port's data path (``deepspeed_tpu_torch/data/``, the engine's
``data_pipeline`` block) against the JAX package's (``deepspeed_tpu/data/``).

The stream, the packer and the pipeline are numpy, so their outputs are
held to the JAX package's exactly: the same indices, arrays equal element
for element, the same states. The prefetcher runs on the CPU here with a
``put_fn`` that copies each array into a CPU tensor (the card's pinned,
side-stream copy runs in ``chip_smoke.py``'s ``data`` phase). The engine
trains a 2-layer, 64-wide GPT from the JAX init (``gpt_state_dict_from_jax``)
on packed documents: losses within 1e-5 relative of the JAX engine's, the
tolerance of ``test_torch_engine.py`` (f32, the order of sums), and the
batches drawn identical. Resume from a checkpoint must be token-identical
and bit-identical in the losses, on one rank and on two gloo ranks (child
processes, ``python tests/test_torch_data.py --worker ...``, torch only;
120 s per child, 60 s group timeout).
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from deepspeed_tpu_torch.data import (  # noqa: E402
    DevicePrefetcher, PackedDataPipeline, SequencePacker, ShardedSampleStream,
    pack_documents)
from deepspeed_tpu_torch.data.prefetch import CopyStream, PlacedBatch  # noqa: E402

SMALL = dict(vocab_size=128, n_positions=128, n_embd=64, n_layer=2, n_head=2)
LOSS_RTOL = 1e-5
CHILD_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60


def documents(n=256, vocab=97, min_len=3, max_len=40, seed=0):
    """Variable-length token documents (some longer than the tests'
    shortest seq_length, 32: the packer's truncation)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=rng.randint(min_len, max_len + 1))
            .astype(np.int32) for _ in range(n)]


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
            assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, k


def drain(it, n):
    return [{k: np.asarray(v).copy() for k, v in next(it).items()}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# ShardedSampleStream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rank,shards", [(0, 1), (1, 2), (2, 4)])
def test_stream_matches_jax_over_two_epochs(rank, shards):
    from deepspeed_tpu.data import ShardedSampleStream as JaxStream

    data = list(range(103))
    mine = ShardedSampleStream(data, seed=5, shard_rank=rank, num_shards=shards)
    ref = JaxStream(data, seed=5, shard_rank=rank, num_shards=shards)
    n = 2 * (len(data) // shards) + 3  # two epochs and into the third
    assert [next(mine) for _ in range(n)] == [next(ref) for _ in range(n)]
    assert mine.state_dict() == ref.state_dict()
    assert mine.epoch == ref.epoch == 2


def test_stream_reseed_and_state_match_jax():
    from deepspeed_tpu.data import ShardedSampleStream as JaxStream

    data = list(range(64))
    mine, ref = (S(data, seed=2, shard_rank=1, num_shards=2)
                 for S in (ShardedSampleStream, JaxStream))
    before = [next(mine) for _ in range(7)]
    assert before == [next(ref) for _ in range(7)]
    v0 = mine.order_version
    mine.reseed(3)
    ref.reseed(3)
    assert mine.order_version == ref.order_version == v0 + 1
    assert mine.seed == ref.seed == 5
    after = [next(mine) for _ in range(7)]
    assert after == [next(ref) for _ in range(7)]
    assert after != before
    # a mid-epoch round trip, and the JAX state into the port's stream
    state = mine.state_dict()
    assert state == ref.state_dict()
    for src in (state, ref.state_dict()):
        fresh = ShardedSampleStream(data, seed=0, shard_rank=1, num_shards=2)
        fresh.load_state_dict(src)
        assert [next(fresh) for _ in range(40)] == _continue_jax(
            data, src, 1, 2, 40)


def _continue_jax(data, state, rank, shards, n):
    from deepspeed_tpu.data import ShardedSampleStream as JaxStream

    ref = JaxStream(data, seed=0, shard_rank=rank, num_shards=shards)
    ref.load_state_dict(state)
    return [next(ref) for _ in range(n)]


@pytest.mark.parametrize("old,new", [(4, 2), (2, 3), (3, 1)])
def test_stream_restride_of_a_jax_state_matches_jax(old, new):
    """A state saved at ``old`` shards (by the JAX stream, mid-epoch) loads
    into the port's stream at ``new`` shards and re-strides to the JAX
    stream's indices on every new rank; with the old ranks' prefix that
    covers the epoch without loss or repeat."""
    from deepspeed_tpu.data import ShardedSampleStream as JaxStream

    data = list(range(60))
    old_ranks = [JaxStream(data, seed=9, shard_rank=r, num_shards=old)
                 for r in range(old)]
    consumed = [next(s) for _ in range(5) for s in old_ranks]
    state = old_ranks[0].state_dict()
    rest = []
    for r in range(new):
        mine = ShardedSampleStream(data, seed=0, shard_rank=r, num_shards=new)
        mine.load_state_dict(state)
        n = (state["epoch_boundary"] - state["cursor"] * old) // new
        got = [next(mine) for _ in range(n)]
        assert got == _continue_jax(data, state, r, new, n)
        rest += got
    boundary = state["epoch_boundary"]
    covered = sorted(consumed + rest)
    assert len(covered) == len(set(covered))
    assert len(covered) >= boundary - new + 1


# ---------------------------------------------------------------------------
# SequencePacker and PackedDataPipeline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("packed", [True, False])
def test_pipeline_batches_match_jax(packed):
    from deepspeed_tpu.data import PackedDataPipeline as JaxPipeline

    docs = documents()
    kw = dict(batch_size=3, seq_length=32, pack_sequences=packed, seed=4,
              pad_token_id=0)
    mine, ref = PackedDataPipeline(docs, **kw), JaxPipeline(docs, **kw)
    got, want = drain(mine, 20), drain(ref, 20)
    assert_batches_equal(got, want)
    assert mine.state_dict() == ref.state_dict()
    if packed:
        assert any(b["segment_ids"].max() > 1 for b in got)
        # every token of every document that fits, in order; a longer one
        # is cut to seq_length
        assert any(len(d) > 32 for d in docs)


def test_packer_and_pack_documents_match_jax():
    from deepspeed_tpu.data import SequencePacker as JaxPacker
    from deepspeed_tpu.data import pack_documents as jax_pack

    docs = documents(60, max_len=50)
    assert_batches_equal(pack_documents(docs, 2, 48), jax_pack(docs, 2, 48))
    mine, ref = SequencePacker(2, 48, pad_id=7), JaxPacker(2, 48, pad_id=7)
    for d in docs[:9]:
        a, b = mine.add({"input_ids": d}), ref.add({"input_ids": d})
        assert (a is None) == (b is None)
        if a is not None:
            assert_batches_equal([a], [b])
    state = mine.state_dict()
    assert state == ref.state_dict()
    assert all(isinstance(t, int) for row in state["rows"] for d in row
               for t in d)
    assert_batches_equal([mine.flush()], [ref.flush()])
    with pytest.raises(ValueError):
        SequencePacker(0, 8)
    with pytest.raises(ValueError):
        mine.add(np.zeros((0,), np.int32))


def test_seqlen_fn_requeue_matches_jax():
    """A target length that changes every few batches (up and down): the
    displaced pending documents are re-queued as the JAX pipeline does,
    batch for batch."""
    from deepspeed_tpu.data import PackedDataPipeline as JaxPipeline

    lengths = [16, 16, 32, 48, 48, 24, 64, 64, 16, 40, 40, 40, 64, 8, 64]
    pipes = []
    for P in (PackedDataPipeline, JaxPipeline):
        step = {"i": 0}
        pipes.append(P(documents(200, max_len=30), batch_size=2,
                       seq_length=64, seed=1,
                       seqlen_fn=lambda s=step: lengths[min(s["i"],
                                                            len(lengths) - 1)]))
        pipes[-1].step = step
    out = [[], []]
    for i in range(len(lengths) + 3):
        for k, p in enumerate(pipes):
            p.step["i"] = i
            out[k].append({kk: v.copy() for kk, v in next(p).items()})
    assert_batches_equal(out[0], out[1])
    assert {b["input_ids"].shape[1] for b in out[0]} > {16, 64}
    assert pipes[0].state_dict() == pipes[1].state_dict()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "jax_to_port_restride"])
def test_pipeline_state_crosses_packages(direction):
    """A pipeline state saved mid-stream (after a seq-len change, with a
    pending row) by one package loads into the other, which continues with
    the same batches; at another shard count both re-stride the same way,
    rank 0 carrying the pending row and rank 1 not."""
    from deepspeed_tpu.data import PackedDataPipeline as JaxPipeline

    docs = documents(300, max_len=30)
    lengths = {"v": 64}
    kw = dict(batch_size=2, seq_length=64, seed=8)
    src_cls, dst_cls = ((JaxPipeline, PackedDataPipeline)
                        if direction.startswith("jax") else
                        (PackedDataPipeline, JaxPipeline))
    src = src_cls(docs, **kw, num_shards=2 if "restride" in direction else 1,
                  seqlen_fn=lambda: lengths["v"])
    drain(src, 5)
    lengths["v"] = 24  # the pending document is re-queued
    drain(src, 1)
    state = src.state_dict()
    assert state["packer"]["rows"] and state["packer"]["seq_len"] == 24
    if "restride" in direction:
        for rank in (0, 1):
            mine = PackedDataPipeline(docs, **kw, shard_rank=rank,
                                      num_shards=3)
            ref = JaxPipeline(docs, **kw, shard_rank=rank, num_shards=3)
            mine.load_state_dict(state)
            ref.load_state_dict(state)
            assert bool(mine._packer.pending_documents()) == (rank == 0)
            assert_batches_equal(drain(mine, 8), drain(ref, 8))
        return
    dst = dst_cls(docs, **kw)
    dst.load_state_dict(state)
    want = drain(src, 10)
    assert_batches_equal(drain(dst, 10), want)


# ---------------------------------------------------------------------------
# DevicePrefetcher on the CPU
# ---------------------------------------------------------------------------
def cpu_put(batch):
    """A put_fn that copies each array into a CPU tensor."""
    return CopyStream("cpu")({k: torch.tensor(v) for k, v in batch.items()})


def _pipe(seed=3, **kw):
    return PackedDataPipeline(documents(128), batch_size=2, seq_length=32,
                              seed=seed, **kw)


def test_prefetcher_is_transparent_and_counts_like_jax():
    from deepspeed_tpu.data import DevicePrefetcher as JaxPrefetcher
    from deepspeed_tpu.data import PackedDataPipeline as JaxPipeline

    want = drain(_pipe(), 8)
    pre = DevicePrefetcher(_pipe(), put_fn=cpu_put, depth=2)
    ref = JaxPrefetcher(JaxPipeline(documents(128), batch_size=2,
                                    seq_length=32, seed=3), depth=2)
    try:
        got = []
        for _ in range(8):
            b = next(pre)
            assert isinstance(b, PlacedBatch) and b.event is None
            assert all(torch.is_tensor(v) for v in b.values())
            got.append({k: v.numpy() for k, v in b.items()})
        assert_batches_equal(got, want)
        assert_batches_equal(drain(ref, 8), want)
        mine_c, ref_c = pre.counters(), ref.counters()
        assert sorted(mine_c) == sorted(ref_c)
        for c in (mine_c, ref_c):
            assert c["prefetch_gets"] == 8.0 and c["prefetch_depth"] == 2.0
            assert 0 <= c["prefetch_queue_depth_avg"] <= 2.0
            assert c["prefetch_queue_depth_max"] <= 2.0
            assert 1.0 <= c["prefetch_starved_gets"] <= 8.0  # the first get
    finally:
        pre.stop()
        ref.stop()


def test_prefetcher_starved_gets_follow_a_slow_loader():
    """A loader slower than the consumer starves every get; a fast one,
    once the queue has filled, none. The fast loader's first item waits
    for a gate that a timer opens only after the consumer has asked for it,
    so the first get finds the queue empty by construction (the worker
    starts inside that ``next``, and could otherwise fill the queue before
    the consumer looks)."""
    class Slow:
        def __init__(self, delay, gate=None):
            self.delay, self.i, self.gate = delay, 0, gate

        def __iter__(self):
            return self

        def __next__(self):
            if self.gate is not None:
                self.gate.wait()
            time.sleep(self.delay)
            self.i += 1
            return {"x": np.full((1,), self.i)}

    gate = threading.Event()
    slow = DevicePrefetcher(Slow(0.25), depth=2)
    fast = DevicePrefetcher(Slow(0.0, gate), depth=2)
    opener = threading.Timer(0.5, gate.set)
    try:
        for _ in range(3):
            next(slow)
        assert slow.counters()["prefetch_starved_gets"] == 3.0
        opener.start()
        next(fast)
        time.sleep(0.3)
        for _ in range(3):
            next(fast)
            time.sleep(0.2)
        c = fast.counters()
        assert c["prefetch_starved_gets"] == 1.0
        assert c["prefetch_queue_depth_max"] == 2.0
    finally:
        opener.cancel()
        gate.set()
        slow.stop()
        fast.stop()


def test_prefetcher_delivered_state_resumes_exactly():
    want = drain(_pipe(), 12)
    pre = DevicePrefetcher(_pipe(), put_fn=cpu_put, depth=3)
    try:
        drain(pre, 5)
        time.sleep(0.1)  # the worker runs ahead
        state = pre.state_dict()
    finally:
        pre.stop()
    resumed = DevicePrefetcher(_pipe(seed=0), put_fn=cpu_put, depth=3)
    try:
        resumed.load_state_dict(state)
        assert_batches_equal(drain(resumed, 7), want[5:])
    finally:
        resumed.stop()


def test_prefetcher_reseed_halts_and_restarts_the_worker():
    pre = DevicePrefetcher(_pipe(seed=6), put_fn=cpu_put, depth=2)
    try:
        v0 = pre.order_version
        a = drain(pre, 4)
        worker = pre._thread
        pre.reseed(1)
        assert not worker.is_alive() and pre._thread is None
        assert pre.order_version == v0 + 1 and pre.seed == 7
        b = drain(pre, 4)
        assert pre._thread is not None and pre._thread is not worker
        assert any(x["input_ids"].tobytes() != y["input_ids"].tobytes()
                   for x, y in zip(a, b))
        fresh = _pipe(seed=6)
        fresh.reseed(1)
        assert_batches_equal(b, drain(fresh, 4))
    finally:
        pre.stop()


def test_prefetcher_finite_loader_stops_and_errors_propagate():
    pre = DevicePrefetcher([{"x": np.arange(3)}] * 3, put_fn=cpu_put)
    assert len(list(pre)) == 3

    def broken():
        yield {"x": np.zeros(2)}
        raise RuntimeError("loader exploded")

    pre = DevicePrefetcher(broken(), put_fn=cpu_put)
    next(pre)
    with pytest.raises(RuntimeError, match="exploded"):
        next(pre)
    with pytest.raises(ValueError):
        DevicePrefetcher([], depth=0)


def test_prefetchers_under_thread_stress():
    """More prefetchers than cores, each drained by its own thread under a
    1 us interpreter switch interval, with a state round trip and a reseed
    midway: every consumer gets its pipeline's batches in order, none lost
    or repeated, and the delivered state resumes at the next one."""
    import threading

    n = 2 * (os.cpu_count() or 4)
    want = drain(_pipe(seed=11), 30)
    reseeded = _pipe(seed=11)
    reseeded.reseed(2)
    want_reseeded = drain(reseeded, 10)
    results, errors = [None] * n, []

    def consume(i):
        pre = DevicePrefetcher(_pipe(seed=11), put_fn=cpu_put, depth=2)
        try:
            got = drain(pre, 12)
            state = pre.state_dict()
            got += drain(pre, 8)
            pre.load_state_dict(state)
            got += drain(pre, 10)
            pre.reseed(2)
            results[i] = (got, drain(pre, 10))
        except BaseException as e:  # reported by the main thread
            errors.append(e)
        finally:
            pre.stop()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    for got, after in results:
        assert_batches_equal(got, want[:20] + want[12:22])
        assert_batches_equal(after, want_reseeded)


# ---------------------------------------------------------------------------
# runtime/dataloader.py against the JAX loader (pad tail, RepeatingLoader)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["pad_helper", "two_epochs_one_shape",
                                  "drop_last", "repeating_state"])
def test_dataloader_matches_jax(case):
    """The contract of the JAX package's ``TestDropLastPadTail``
    (``tests/unit/test_data_pipeline.py``), held between the two loaders."""
    from deepspeed_tpu.runtime import dataloader as jdl

    from deepspeed_tpu_torch.runtime import dataloader as tdl

    if case == "pad_helper":
        batch = {"input_ids": np.ones((3, 8), np.int32),
                 "labels": np.ones((3, 8), np.int32)}
        assert_batches_equal([tdl._pad_to_batch_size(batch, 4)],
                             [jdl._pad_to_batch_size(batch, 4)])
        return
    data = [{"input_ids": np.full((8,), i, np.int32),
             "labels": np.full((8,), i, np.int32)} for i in range(10)]
    drop_last = case == "drop_last"
    loaders = [m.DeepSpeedDataLoader(data, batch_size=4, shuffle=True,
                                     seed=2, drop_last=drop_last)
               for m in (tdl, jdl)]
    its = [iter(m.RepeatingLoader(lo)) for m, lo in zip((tdl, jdl), loaders)]
    got, want = drain(its[0], 6), drain(its[1], 6)  # two epochs
    assert_batches_equal(got, want)
    assert len({tuple(sorted((k, v.shape) for k, v in b.items()))
                for b in got}) == 1
    assert ("attention_mask" in got[0]) == (not drop_last)
    if case == "repeating_state":
        mine, ref = (m.RepeatingLoader(lo)
                     for m, lo in zip((tdl, jdl), loaders))
        assert mine.state_dict() == ref.state_dict() == {"epoch": 1,
                                                         "seed": 2}
        mine.load_state_dict({"epoch": 5, "seed": 1})
        ref.load_state_dict({"epoch": 5, "seed": 1})
        assert_batches_equal(drain(mine, 3), drain(ref, 3))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def ds_config(prefetch=True, curriculum=True, gas=1, **pipe):
    ds = {"train_micro_batch_size_per_gpu": 2,
          "gradient_accumulation_steps": gas, "gradient_clipping": 1.0,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": 1e-3, "weight_decay": 0.1}},
          "data_pipeline": dict({"enabled": True, "seq_length": 64,
                                 "prefetch": prefetch, "prefetch_depth": 2,
                                 "seed": 3}, **pipe),
          "steps_per_print": 10 ** 9}
    if curriculum:
        ds["curriculum_learning"] = {
            "enabled": True, "curriculum_type": "seqlen",
            "min_difficulty": 16, "max_difficulty": 64,
            "schedule_type": "fixed_linear",
            "schedule_config": {"total_curriculum_step": 5,
                                "difficulty_step": 16}}
    return ds


class Recorder:
    """The batches an engine draws from ``it``, as numpy arrays in the
    pipeline's dtype (a placed batch is waited for first, and must hold the
    int64 tensors the engine casts to)."""

    def __init__(self, it):
        self.it, self.seen = it, []

    def __iter__(self):
        return self

    def __next__(self):
        b = next(self.it)
        if isinstance(b, PlacedBatch):
            assert all(v.dtype == torch.int64 for v in b.wait().values())
            self.seen.append({k: v.numpy().astype(np.int32)
                              for k, v in b.items()})
        else:
            self.seen.append({k: np.asarray(v).copy() for k, v in b.items()})
        return b


def jax_init():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import transformer_lm as jlm

    jmodel = jlm.GPT(jlm.GPTConfig(**SMALL, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    return jmodel, params


def port_engine(ds, params, docs, seed=0):
    import jax

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    cfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    return deepspeed_tpu_torch.initialize(
        model=tlm.GPT(cfg), config=ds, device="cpu", seed=seed,
        training_data=docs,
        model_parameters=gpt_state_dict_from_jax(jax.device_get(params), cfg))


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX engine on one device, packed pipeline without prefetch (its
    prefetcher reads the curriculum's difficulty of the moment), curriculum
    on: 6 steps' losses and the batches it drew."""
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.parallel.mesh import MeshTopology

    jmodel, params = jax_init()
    docs = documents(400, vocab=SMALL["vocab_size"], max_len=40)
    out = {"params": params, "docs": docs}
    for gas in (1, 2):
        eng, _, loader, _ = deepspeed_tpu.initialize(
            model=jmodel, config=ds_config(prefetch=False, gas=gas),
            model_parameters=params, training_data=docs,
            topology=MeshTopology(dp=1, devices=jax.devices()[:1]))
        it = Recorder(iter(loader))
        losses = [float(eng.train_batch(it)) for _ in range(6)]
        out[gas] = {"losses": losses, "batches": it.seen,
                    "difficulty": eng.curriculum_scheduler.current_difficulty}
    return out


@pytest.mark.parametrize("prefetch,gas", [(False, 1), (True, 1), (True, 2)])
def test_engine_trains_packed_documents_like_jax(prefetch, gas, jax_reference):
    ref = jax_reference[gas]
    engine, _, loader, _ = port_engine(ds_config(prefetch=prefetch, gas=gas),
                                       jax_reference["params"],
                                       jax_reference["docs"])
    try:
        assert isinstance(loader, DevicePrefetcher if prefetch
                          else PackedDataPipeline)
        it = Recorder(iter(loader))
        losses = [float(engine.train_batch(it)) for _ in range(6)]
    finally:
        engine.destroy()
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert_batches_equal(it.seen, ref["batches"])
    shapes = [b["input_ids"].shape[1] for b in it.seen]
    assert len(set(shapes)) >= 3, shapes  # the curriculum moved
    assert engine.curriculum_scheduler.current_difficulty == ref["difficulty"]


def test_data_blocks_are_ported_and_other_refusals_stay():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                    DeepSpeedConfigError)

    cfg = DeepSpeedConfig(ds_config())
    assert cfg.unported_features() == []
    for bad in ({"seq_length": 1}, {"prefetch_depth": 0}, {"shard": "zone"}):
        with pytest.raises(DeepSpeedConfigError):
            DeepSpeedConfig(ds_config(**bad))
    for block in ({"sentinel": {"enabled": True}},
                  {"step_profiler": {"enabled": True}},
                  {"eigenvalue": {"enabled": True}}):
        with pytest.raises(NotImplementedError):
            deepspeed_tpu_torch.initialize(
                model=tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float32)),
                config=dict(ds_config(), **block), device="cpu")


def test_put_batch_passes_a_placed_batch_through():
    """A batch the prefetch worker placed is taken as it is (no second
    slice or cast); anything else is cast and moved."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float32)),
        config=ds_config(), device="cpu")[0]
    ids = torch.arange(8, dtype=torch.int64).view(2, 4)
    placed = PlacedBatch({"input_ids": ids})
    assert engine._put_batch(placed)["input_ids"] is ids
    host = engine._put_batch({"input_ids": ids.numpy().astype(np.int32)})
    assert host["input_ids"].dtype == torch.int64
    assert torch.equal(host["input_ids"], ids)


@pytest.mark.parametrize("prefetch", [False, True])
def test_checkpoint_resume_is_token_identical(prefetch, tmp_path):
    """Save after 3 steps; a fresh engine (another seed's weights) loads
    the tag and its next 4 batches and losses equal the uninterrupted
    run's, bit for bit."""
    _, params = jax_init()
    docs = documents(300, vocab=SMALL["vocab_size"], max_len=40)
    ds = ds_config(prefetch=prefetch)
    engine, _, loader, _ = port_engine(ds, params, docs)
    it = Recorder(iter(loader))
    for _ in range(3):
        engine.train_batch(it)
    time.sleep(0.05)  # the worker runs ahead of the save
    engine.save_checkpoint(str(tmp_path))
    want = [float(engine.train_batch(it)) for _ in range(4)]
    engine.destroy()
    fresh, _, loader2, _ = port_engine(ds, params, docs, seed=1)
    fresh.load_checkpoint(str(tmp_path))
    it2 = Recorder(iter(loader2))
    got = [float(fresh.train_batch(it2)) for _ in range(4)]
    fresh.destroy()
    assert got == want
    assert_batches_equal(it2.seen, it.seen[3:])


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------
RANK_DOCS = dict(n=240, vocab=SMALL["vocab_size"], max_len=40, seed=2)


def _rank_job(rank, world, tmp, shard, load=None, steps=4, save_after=None):
    """One rank's run: ``steps`` steps on the packed pipeline (prefetch on,
    no curriculum), saving after ``save_after``; returns the batches drawn,
    the losses and the documents consumed (by first token run)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    ds = ds_config(curriculum=False, shard=shard)
    ds["zero_optimization"] = {"stage": 1}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float32)),
        config=ds, device="cpu", seed=0, training_data=documents(**RANK_DOCS))
    out = {}
    if load:
        engine.load_checkpoint(load)
        out["stream"] = loader.state_dict()["stream"]
    it = Recorder(iter(loader))
    out["losses"] = []
    for i in range(steps):
        out["losses"].append(float(engine.train_batch(it)))
        if save_after is not None and i + 1 == save_after:
            engine.save_checkpoint(os.path.join(tmp, "ckpt"))
            out["saved_stream"] = loader.state_dict()["stream"]
    engine.destroy()
    out["batches"] = it.seen
    return out


def _worker(argv):
    tmp, rank, world, url, out = argv
    rank, world = int(rank), int(world)
    from datetime import timedelta

    from deepspeed_tpu_torch import comm

    torch.set_num_threads(1)
    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          timeout=timedelta(seconds=GROUP_TIMEOUT_S),
                          device_type="cpu")
    ckpt = os.path.join(tmp, "ckpt")
    res = {"process": _rank_job(rank, world, tmp, "process", steps=5,
                                save_after=2),
           "none": _rank_job(rank, world, tmp, "none", steps=3)}
    comm.barrier()
    res["resumed"] = _rank_job(rank, world, tmp, "process", load=ckpt,
                               steps=3)
    torch.save(res, out)
    comm.destroy_distributed()
    return 0


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("data_ranks"))
    rdv = os.path.join(tmp, "rendezvous")
    procs, outs = [], []
    for rank in range(2):
        outs.append(os.path.join(tmp, f"rank{rank}.pt"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", tmp,
             str(rank), "2", f"file://{rdv}", outs[-1]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1")))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return {"tmp": tmp,
            "ranks": [torch.load(o, weights_only=False) for o in outs]}


def _docs_of(batch):
    """The documents of a packed batch, as tuples of tokens."""
    out = []
    for ids, seg in zip(batch["input_ids"], batch["segment_ids"]):
        for s in range(1, int(seg.max()) + 1):
            out.append(tuple(ids[seg == s].tolist()))
    return out


def test_shard_process_ranks_pack_disjoint_strides(two_ranks):
    """``shard: "process"``: each rank packs its own 2 rows from its own
    stride; the documents the ranks drew are disjoint and are the
    stream's prefix, rank by rank, as the port's single-shard streams
    give them."""
    ranks = two_ranks["ranks"]
    drawn = [[d for b in r["process"]["batches"] for d in _docs_of(b)]
             for r in ranks]
    assert all(b["input_ids"].shape == (2, 64)
               for r in ranks for b in r["process"]["batches"])
    assert not set(drawn[0]) & set(drawn[1])
    docs = documents(**RANK_DOCS)
    for rank in (0, 1):
        stream = ShardedSampleStream(docs, seed=3, shard_rank=rank,
                                     num_shards=2)
        # first fit places a later document in an earlier row: the set of
        # documents of the batches so far is the stride's prefix
        own = [tuple(next(stream)[:64].tolist())
               for _ in range(len(drawn[rank]))]
        assert sorted(drawn[rank]) == sorted(own)
    assert ranks[0]["process"]["losses"] == ranks[1]["process"]["losses"]


def test_shard_none_rows_are_slices_of_the_world_1_batch(two_ranks):
    """``shard: "none"``: every rank packs the global micro batch (4 rows)
    and keeps its 2; the rows equal those of a one-rank pipeline."""
    ranks = two_ranks["ranks"]
    ref = PackedDataPipeline(documents(**RANK_DOCS), batch_size=4,
                             seq_length=64, seed=3)
    for b0, b1 in zip(ranks[0]["none"]["batches"],
                      ranks[1]["none"]["batches"]):
        # the prefetch worker hands each rank its slice
        want = next(ref)
        for rank, got in enumerate((b0, b1)):
            assert_batches_equal(
                [got], [{k: v[2 * rank:2 * rank + 2] for k, v in want.items()}])


def test_per_rank_resume_is_token_identical(two_ranks):
    """Saved after 2 steps at world 2 and resumed at world 2: every rank's
    next batches are its own uninterrupted ones (its own cursor, not rank
    0's), and the losses are bit-identical."""
    for r in two_ranks["ranks"]:
        run, resumed = r["process"], r["resumed"]
        assert resumed["stream"] == run["saved_stream"]
        assert_batches_equal(resumed["batches"], run["batches"][2:5])
        assert resumed["losses"] == run["losses"][2:5]
    cursors = [r["process"]["saved_stream"]["cursor"]
               for r in two_ranks["ranks"]]
    assert cursors[0] != cursors[1]  # packing: the ranks' cursors differ


def test_resume_at_world_1_restrides(two_ranks):
    """The world-2 tag on one rank without a group: the stream re-strides
    from rank 0's state (the JAX arithmetic: the frontier is rank 0's
    cursor times 2), and rank 0's pending rows come along."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    ds = ds_config(curriculum=False)
    ds["zero_optimization"] = {"stage": 1}
    engine, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float32)),
        config=ds, device="cpu", training_data=documents(**RANK_DOCS))
    try:
        engine.load_checkpoint(os.path.join(two_ranks["tmp"], "ckpt"))
        saved = two_ranks["ranks"][0]["process"]["saved_stream"]
        state = loader.state_dict()
        assert state["stream"]["num_shards"] == 1
        assert state["stream"]["cursor"] == 0
        assert state["stream"]["epoch_offset"] == 2 * saved["cursor"]
        assert engine.global_steps == 2
        loss = float(engine.train_batch(iter(loader)))
        assert np.isfinite(loss)
    finally:
        engine.destroy()


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(sys.argv[2:]))
