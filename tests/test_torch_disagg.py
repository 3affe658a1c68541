"""Disaggregated prefill, ``build_serving`` and the serving events against
the JAX package.

A 2-layer narrow ring GPT (window block 16, rotary) with its KV cache in
int8 and one slack block serves 5 prompts through ``DisaggServer`` (one
``PrefillWorker``) over a scheduler with speculative decoding (k 4, a
draft of the target's weights), every prompt submitted before ``run``: the
hand-offs must not alias the engine's batch-1 cache, which each prefill
overwrites. The JAX package runs the same once per module; the tokens must
be JAX's, and the events (the scheduler's, ``serve.kv_transfer``) JAX's
kinds in order with JAX's payload keys. A hand-off's and ``lane_kv_bytes``'
key, value and scale bytes must be JAX's, in int8 and in the compute
dtype; the port keeps one ``valid`` and ``index`` (and a ring's
``slot_pos``) for all layers where flax keeps them per layer, and those
bytes are checked from the shapes. Also: the bucket refusals,
``build_serving``'s knobs and its unknown-key error, ``_default_align``,
and the prefix cache's, the prefetcher's, the submit-time rejections' and
the ring decline's events against JAX's.
"""

import dataclasses
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.serving as jserving
import deepspeed_tpu.telemetry.bus as jbus
import deepspeed_tpu_torch
import deepspeed_tpu_torch.serving as tserving
import deepspeed_tpu_torch.telemetry.bus as tbus
from deepspeed_tpu.data.prefetch import DevicePrefetcher as JaxPrefetcher
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.ops.sparse_attention import sparse_attention_utils as jsa
from deepspeed_tpu.serving import prefix_cache as jpc
from deepspeed_tpu_torch.data.prefetch import DevicePrefetcher
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.ops.sparse_attention import \
    sparse_attention_utils as tsa
from deepspeed_tpu_torch.serving import prefix_cache as tpc

torch.set_num_threads(2)

WINDOW = {"mode": "local_sliding_window", "block": 16,
          "num_sliding_window_blocks": 3}
BASE = dict(vocab_size=128, n_positions=256, n_embd=32, n_layer=2,
            n_head=4, rotary=True, learned_positions=False)
SLOTS, K, NEW = 3, 4, 8
KV_NAMES = ("cached_key", "cached_value", "cached_key_scale",
            "cached_value_scale")


def _prompts(seed=0, lengths=(7, 23, 40, 70, 12)):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 128, size=n)] for n in lengths]


def _models(**fields):
    jm = jsa.apply_sparse_attention(
        jlm.GPT(jlm.GPTConfig(**BASE, dtype=jnp.float32, **fields)), WINDOW)
    tm = tsa.apply_sparse_attention(
        tlm.GPT(tlm.GPTConfig(**BASE, dtype=torch.float32, **fields)), WINDOW)
    return jm, tm


def _strip(events, kinds=None):
    return [{k: v for k, v in ev.items() if k != "ts"} for ev in events
            if kinds is None or ev["kind"] in kinds]


def _jax_kv_bytes(tree):
    """JAX's key, value and scale bytes, and all of its cache's bytes."""
    kv = total = 0

    def acc(path, leaf):
        nonlocal kv, total
        name = path[-1].key if hasattr(path[-1], "key") else path[-1]
        n = leaf.size * jnp.dtype(leaf.dtype).itemsize
        total += n
        kv += n if name in KV_NAMES else 0

    jax.tree_util.tree_map_with_path(acc, tree)
    return kv, total


def _bookkeeping(cfg, ring_slots):
    """The bytes the port keeps once per row: ``valid`` [S] bool, ``index``
    int64, a ring's ``slot_pos`` [S] int64 (no ``position``: rotary)."""
    return ring_slots + 8 + 8 * ring_slots


@pytest.fixture(scope="module")
def served():
    """The JAX run: its engines, tokens, events and a hand-off; and the
    port's engines on the same weights."""
    jm, tm = _models(kv_cache_slack_blocks=1, kv_cache_dtype="int8")
    jdm, tdm = _models()
    config = {"dtype": "fp32"}
    jeng = JaxEngine(jm, dict(config), seed=0)
    jdraft = JaxEngine(jdm, dict(config), seed=0)
    prompts = _prompts()
    events = []
    jbus.telemetry_bus.subscribe(events.append)
    try:
        sched = jserving.build_serving(
            jeng, {"slots": SLOTS, "prompt_bucket": 16, "spec_k": K},
            draft_engine=jdraft)
        server = jserving.DisaggServer(sched, [jserving.PrefillWorker(
            jeng, prompt_bucket=16)])
        rids = [server.submit(p, max_new_tokens=NEW) for p in prompts]
        stats = server.run()
    finally:
        jbus.telemetry_bus.unsubscribe(events.append)
    by_rid = {c.request_id: c.tokens for c in stats.completions}
    handoff = jserving.PrefillWorker(jeng, prompt_bucket=16).prefill(
        prompts[3])
    sd = gpt_state_dict_from_jax(jax.device_get(jeng.params), tm.config)
    port = deepspeed_tpu_torch.init_inference(tm, config=dict(config),
                                              device="cpu", state_dict=sd)
    draft = deepspeed_tpu_torch.init_inference(tdm, config=dict(config),
                                               device="cpu", state_dict=sd)
    return dict(jax=jeng, jax_model=jm, port=port, draft=draft,
                prompts=prompts, tokens=[list(by_rid[r]) for r in rids],
                events=_strip(events), handoff=handoff)


def _port_run(served):
    events = []
    tbus.telemetry_bus.subscribe(events.append)
    try:
        sched = tserving.build_serving(
            served["port"], {"slots": SLOTS, "prompt_bucket": 16,
                             "spec_k": K}, draft_engine=served["draft"])
        worker = tserving.PrefillWorker(served["port"], prompt_bucket=16)
        server = tserving.DisaggServer(sched, [worker])
        rids = [server.submit(p, max_new_tokens=NEW)
                for p in served["prompts"]]
        stats = server.run()
    finally:
        tbus.telemetry_bus.unsubscribe(events.append)
    by_rid = {c.request_id: c.tokens for c in stats.completions}
    return [by_rid[r] for r in rids], _strip(events), server, sched


def test_disagg_tokens_match_jax_with_every_prompt_queued(served):
    got, events, server, sched = _port_run(served)
    assert got == served["tokens"]
    assert server.handoffs == len(served["prompts"])
    assert sched.spec_accepted > 0
    # the queued hand-offs own their caches: one per request, none the
    # engine's batch-1 cache
    st = server.stats()
    assert st["workers"] == [{"replica": 0, "prefills": 5,
                              "kv_bytes": server.handoff_bytes}]


def test_events_match_jax_kinds_and_keys(served):
    _, events, _, _ = _port_run(served)
    want = served["events"]
    assert [e["kind"] for e in events] == [e["kind"] for e in want]
    assert [sorted(e) for e in events] == [sorted(e) for e in want]
    for kind, keys in (("serve.admit", ("request_id", "lane", "prompt_len",
                                        "replayed", "queue_depth")),
                       ("serve.first_token", ("request_id", "lane")),
                       ("serve.evict", ("request_id", "lane", "tokens",
                                        "queue_depth")),
                       ("serve.spec_accept", ("k", "lanes", "proposed",
                                              "accepted", "proposed_total",
                                              "accepted_total")),
                       ("serve.stats", ("queue_depth", "lanes_active", "shed",
                                        "deadline_shed", "decode_steps",
                                        "draining")),
                       ("serve.kv_transfer", ("request_id", "from_replica",
                                              "to_replica",
                                              "transfers_total"))):
        pick = [[e[k] for k in keys] for e in events if e["kind"] == kind]
        assert pick == [[e[k] for k in keys] for e in want
                        if e["kind"] == kind], kind
        assert pick


def test_handoff_and_lane_bytes_match_jax(served):
    jax_kv, jax_total = _jax_kv_bytes(served["handoff"].cache)
    assert jax_total == served["handoff"].nbytes
    got, events, _, _ = _port_run(served)
    cfg = served["port"].module.config
    lane = tserving.lane_kv_bytes(served["port"].module)
    ring_slots = served["port"]._decoder(1).cache.valid.shape[1]
    port_kv = lane["resident_bytes"] - _bookkeeping(cfg, ring_slots)
    assert port_kv == jax_kv
    transfers = [e for e in events if e["kind"] == "serve.kv_transfer"]
    assert {e["bytes"] for e in transfers} == {lane["resident_bytes"]}
    h = tserving.PrefillWorker(served["port"], prompt_bucket=16).prefill(
        served["prompts"][3])
    assert h.nbytes == lane["resident_bytes"] == \
        tserving.disagg.tree_nbytes(h.cache)
    assert h.first_token == served["handoff"].first_token
    assert h.cache.key[0].dtype == torch.int8
    assert h.cache.key[0].data_ptr() != \
        served["port"]._decoder(1).cache.key[0].data_ptr()
    # JAX keeps valid and index in each layer, the port once
    jlane = jserving.lane_kv_bytes(served["jax_model"])
    assert jlane["resident_bytes"] - jax_kv == \
        jax_total - jax_kv > _bookkeeping(cfg, ring_slots)
    assert lane["unquantized_bytes"] - _bookkeeping(cfg, ring_slots) == \
        jlane["unquantized_bytes"] - (jax_total - jax_kv)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32_kv", "int8_kv"])
def test_lane_kv_bytes_allocate_nothing_and_match_jax(kv):
    jm, tm = _models(kv_cache_dtype=kv)
    jlane = jserving.lane_kv_bytes(jm)
    lane = tserving.lane_kv_bytes(tm)
    for slots in (1, 3):
        cache = tlm.kv_cache(tm.config, slots, torch.device("meta"))
        assert all(t.is_meta for t in cache.tensors())
        assert tserving.disagg.tree_nbytes(cache) == \
            slots * lane["resident_bytes"]
    ring_slots = tlm.kv_cache(tm.config, 1, "meta").valid.shape[1]
    side = _bookkeeping(tm.config, ring_slots)
    # keys and values of 2 layers: int8 codes and an f32 scale per (slot,
    # head), or f32
    n = 2 * 2 * ring_slots * tm.config.kv_heads
    kv_bytes = (n * tm.config.head_dim + 4 * n if kv == "int8"
                else 4 * n * tm.config.head_dim)
    assert lane["resident_bytes"] == kv_bytes + side
    j_side = jlane["resident_bytes"] - kv_bytes
    assert j_side > side
    assert lane["unquantized_bytes"] - side == \
        jlane["unquantized_bytes"] - j_side
    ratio = lane["unquantized_bytes"] / lane["resident_bytes"]
    assert (ratio > 2) == (kv == "int8")


def test_bucket_refusals_match_jax(served):
    tsched = tserving.ContinuousBatchingScheduler(served["port"], slots=2,
                                                  prompt_bucket=16)
    jsched = jserving.ContinuousBatchingScheduler(served["jax"], slots=2,
                                                  prompt_bucket=16)
    msgs = []
    for serving, eng, sched in ((tserving, served["port"], tsched),
                                (jserving, served["jax"], jsched)):
        with pytest.raises(ValueError) as e1:
            serving.DisaggServer(sched, [serving.PrefillWorker(
                eng, prompt_bucket=32)])
        with pytest.raises(ValueError) as e2:
            serving.PrefillWorker(eng, prompt_bucket=24)
        with pytest.raises(ValueError) as e3:
            serving.DisaggServer(sched, [])
        msgs.append([str(e.value) for e in (e1, e2, e3)])
    assert msgs[0] == msgs[1]
    assert tserving.PrefillWorker(served["port"]).prompt_bucket == 16


KNOBS = [{}, {"prefix_cache": True, "admission": True, "journal": True},
         {"slots": 3, "prompt_bucket": 32, "temperature": 0.0,
          "eos_token_id": 5, "max_pending": 9,
          "prefix_cache": {"promote_after": 3, "budget_bytes": 1 << 20},
          "admission": {"slo_ttft_p95_s": 1.5, "window": 16},
          "journal": {"retain_done": False}},
         {"slots": 2, "prefix_cache": False, "admission": False,
          "journal": False}]


def _knobs(sched):
    pc, adm, jr = sched.prefix_cache, sched.admission_controller, \
        sched.journal
    return {"slots": sched.slots, "bucket": sched.prompt_bucket,
            "temperature": sched.temperature, "eos": sched.eos_token_id,
            "max_pending": sched.max_pending, "spec_k": sched.spec_k,
            "prefix": None if pc is None else dataclasses.asdict(pc.config),
            "admission": None if adm is None else dataclasses.asdict(
                adm.config),
            "journal": None if jr is None else jr._retain_done}


@pytest.mark.parametrize("knobs", range(len(KNOBS)),
                         ids=["empty", "defaults", "all", "off"])
def test_build_serving_knobs_match_jax(served, knobs):
    cfg = KNOBS[knobs]
    got = tserving.build_serving(served["port"], dict(cfg))
    want = jserving.build_serving(served["jax"], dict(cfg))
    assert _knobs(got) == _knobs(want)
    if cfg.get("prefix_cache") and isinstance(cfg["prefix_cache"], dict):
        assert got.prefix_cache.budget_bytes == want.prefix_cache.budget_bytes
    errors = []
    for serving, eng in ((tserving, served["port"]),
                         (jserving, served["jax"])):
        with pytest.raises(ValueError) as e:
            serving.build_serving(eng, dict(cfg, spec=4, slot=2))
        errors.append(str(e.value))
    assert errors[0] == errors[1] == \
        "unknown serving config keys: ['slot', 'spec']"


class _Engine:
    def __init__(self, config):
        self.module = type("M", (), {"config": config})()


@pytest.mark.parametrize("ring", [False, True], ids=["dense", "ring"])
@pytest.mark.parametrize("bucket", [None, 32])
def test_default_align_matches_jax(ring, bucket):
    fields = {} if ring else {"learned_positions": True, "rotary": False}
    jc = jlm.GPTConfig(**{**BASE, **fields}, dtype=jnp.float32)
    tc = tlm.GPTConfig(**{**BASE, **fields}, dtype=torch.float32)
    if ring:
        jc = jsa.apply_sparse_attention(jlm.GPT(jc), WINDOW).config
        tc = tsa.apply_sparse_attention(tlm.GPT(tc), WINDOW).config
    got = tserving._default_align(_Engine(tc), bucket)
    assert got == jserving._default_align(_Engine(jc), bucket)
    assert got == (16 if ring else bucket or 64)


def _prefix_script(pc_mod, seed):
    """Lookups, promotions and inserts of numpy entries under a small
    budget (evictions), on the module's global bus."""
    rng = np.random.default_rng(seed)
    cache = pc_mod.PrefixCache(pc_mod.PrefixCacheConfig(
        align=4, promote_after=2, budget_bytes=1500))
    bus = jbus.telemetry_bus if pc_mod is jpc else tbus.telemetry_bus
    events = []
    bus.subscribe(events.append)
    try:
        bases = [[int(t) for t in rng.integers(0, 50, 12)] for _ in range(3)]
        for rid in range(40):
            cols = tuple([-1] * int(rng.integers(0, 2)) +
                         bases[int(rng.integers(0, 3))] +
                         [int(t) for t in rng.integers(0, 50, 3)])
            entry = cache.lookup(cols, limit=len(cols) - 1, request_id=rid)
            have = 0
            if entry is not None:
                have = entry.length
                cache.release(entry)
            target = cache.promotion_target(cols, limit=len(cols) - 1,
                                            have=have)
            if target is not None:
                cache.insert(cols[:target], {"k": np.zeros(
                    10 * target, np.float32)}, request_id=rid)
    finally:
        bus.unsubscribe(events.append)
    return _strip(events), cache.stats()


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_cache_events_match_jax(seed):
    got = _prefix_script(tpc, seed)
    assert got == _prefix_script(jpc, seed)
    kinds = {e["kind"] for e in got[0]}
    assert kinds == {"serve.prefix_hit", "serve.prefix_miss",
                     "serve.prefix_evict"}


class _SlowLoader:
    """An endless loader whose every item comes after a pause, so the
    consumer finds the queue empty (a starved get) at least at its first
    get and, unless it stalls as long as the pause, at every get."""

    def __iter__(self):
        i = 0
        while True:
            time.sleep(0.2)
            yield {"x": np.full(2, i)}
            i += 1


def _prefetch_events(prefetcher, bus):
    events = []
    bus.subscribe(events.append)
    loader = prefetcher(_SlowLoader(), depth=2)
    try:
        items = [int(next(loader)["x"][0]) for _ in range(3)]
    finally:
        loader.stop()
        bus.unsubscribe(events.append)
    events = _strip(events, {"data.prefetch_starved"})
    return (items, events[:1], [(e["kind"], e["severity"], tuple(sorted(e)))
                                for e in events],
            [e["starved_gets"] for e in events], events[-1]["gets"])


def test_prefetch_starvation_events_match_jax():
    got = _prefetch_events(DevicePrefetcher, tbus.telemetry_bus)
    want = _prefetch_events(JaxPrefetcher, jbus.telemetry_bus)
    assert got[:2] == want[:2]
    assert got[0] == [0, 1, 2]
    assert got[1] == [{"kind": "data.prefetch_starved", "rank": 0,
                       "severity": "warning", "starved_gets": 1, "gets": 1}]
    assert set(got[2]) == set(want[2]) and len(set(got[2])) == 1
    assert got[3] == list(range(1, len(got[3]) + 1)) and got[4] <= 3


def _rejections(serving, eng, bus):
    events = []
    bus.subscribe(events.append)
    try:
        sched = serving.ContinuousBatchingScheduler(eng, slots=2,
                                                    prompt_bucket=16,
                                                    max_pending=1)
        sched.submit([1, 2, 3], max_new_tokens=2)
        out = []
        for kw in ({}, {"deadline_s": 0.0}):
            with pytest.raises(serving.AdmissionRejected) as e:
                sched.submit([4, 5], max_new_tokens=2, **kw)
            out.append(e.value.reason)
        sched.begin_drain("test")
        sched.begin_drain("again")
        with pytest.raises(serving.DrainingError):
            sched.submit([6], max_new_tokens=2)
    finally:
        bus.unsubscribe(events.append)
    return out, sched.shed_count, sched.deadline_shed_count, _strip(events)


def test_submit_rejections_and_drain_events_match_jax(served):
    got = _rejections(tserving, served["port"], tbus.telemetry_bus)
    assert got == _rejections(jserving, served["jax"], jbus.telemetry_bus)
    assert [e["kind"] for e in got[3]] == [
        "serve.shed", "serve.deadline_shed", "serve.drain", "serve.shed"]


def _decline(sa, bus):
    events = []
    bus.subscribe(events.append)
    n = len(sa.RING_DECLINES)
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            sa._decline_demanded_ring("layout X has no ring expression")
    finally:
        bus.unsubscribe(events.append)
    return (sa.RING_DECLINES[n:], _strip(events),
            [(x.category.__name__, str(x.message)) for x in w])


def test_ring_decline_event_matches_jax():
    got = _decline(tsa, tbus.telemetry_bus)
    assert got == _decline(jsa, jbus.telemetry_bus)
    assert got[1][0]["kind"] == "ring.decline"
