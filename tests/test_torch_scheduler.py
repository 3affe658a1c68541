"""The port's continuous-batching scheduler against the JAX package's.

The JAX engines draw the weights; ``gpt_state_dict_from_jax`` carries them
to the port's engines on the CPU, in f32. Greedy decoding in f32 on the CPU
gives the same tokens in both packages, so the port's scheduler must emit
exactly the JAX scheduler's tokens under staggered admissions (7 requests
through 3 lanes: lanes freed and refilled), for a dense and a ring-cached
model, with the KV cache in the compute dtype and in int8 (mirroring
``tests/unit/test_serving.py:161-271`` and
``tests/unit/test_serving_disagg.py:361-381``), and each request's tokens
must be its solo ``generate``'s. The JAX engines and their scheduler runs
are made once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.inference.scheduler import \
    ContinuousBatchingScheduler as JaxScheduler
from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.ops.sparse_attention.sparse_attention_utils import \
    apply_sparse_attention as jax_sparse
from deepspeed_tpu_torch.inference.scheduler import (
    ContinuousBatchingScheduler, DeadlineExceededError, DrainingError,
    QueueFullError, Request, RequestShedError)
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import \
    apply_sparse_attention

torch.set_num_threads(2)

# block 16, 3 window blocks: w_blk 1, a 32-slot ring
WINDOW = {"mode": "local_sliding_window", "block": 16,
          "num_sliding_window_blocks": 3}
BASE = dict(vocab_size=128, n_positions=256, n_embd=64, n_layer=2, n_head=4)
RING_FIELDS = dict(rotary=True, learned_positions=False)
# sub-block to 2.2x the ring; 7 requests through 3 lanes
LENGTHS = (7, 23, 40, 70, 12, 33, 5)
NEW = 8


def _prompts(seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 128, size=n)] for n in lengths]


def _models(ring, **fields):
    if ring:
        fields = {**RING_FIELDS, **fields}
    jm = jlm.GPT(jlm.GPTConfig(**BASE, dtype=jnp.float32, **fields))
    tm = tlm.GPT(tlm.GPTConfig(**BASE, dtype=torch.float32, **fields))
    if ring:
        jm, tm = jax_sparse(jm, WINDOW), apply_sparse_attention(tm, WINDOW)
    return jm, tm


def _run(sched, prompts, new=NEW, **kw):
    for p in prompts:
        sched.submit(p, max_new_tokens=new, **kw)
    stats = sched.run()
    got = {c.request_id: c.tokens for c in stats.completions}
    return stats, [got[i] for i in range(len(prompts))]


class _Pair:
    """A JAX engine, its scheduler's tokens, and the port's engine on the
    same weights."""

    def __init__(self, ring, kv=None):
        jm, tm = _models(ring)
        config = {"dtype": "fp32"}
        if kv is not None:
            config["kv_cache"] = kv
        self.jax = JaxEngine(jm, dict(config), seed=0)
        _, self.want = _run(JaxScheduler(self.jax, slots=3,
                                         prompt_bucket=16), _prompts())
        sd = gpt_state_dict_from_jax(jax.device_get(self.jax.params),
                                     tm.config)
        self.port = deepspeed_tpu_torch.init_inference(
            tm, config=dict(config), device="cpu", state_dict=sd)

    def scheduler(self, **kw):
        return ContinuousBatchingScheduler(self.port, slots=3,
                                           prompt_bucket=16, **kw)


@pytest.fixture(scope="module")
def pairs():
    return {(ring, kv): _Pair(ring, kv) for ring in (False, True)
            for kv in (None, "int8")}


def _solo(engine, prompt, new=NEW, min_len=48):
    """The request alone through ``generate`` (right-padded to a block
    multiple; generate left-aligns it)."""
    L = max(min_len, -(-len(prompt) // 16) * 16)
    ids = np.zeros((1, L), np.int64)
    mask = np.zeros((1, L), bool)
    ids[0, :len(prompt)] = prompt
    mask[0, :len(prompt)] = True
    return engine.generate(ids, max_new_tokens=new,
                           attention_mask=torch.from_numpy(mask))[0].tolist()


@pytest.mark.parametrize("kv", [None, "int8"], ids=["compute_kv", "int8_kv"])
@pytest.mark.parametrize("ring", [False, True], ids=["dense", "ring"])
def test_staggered_admissions_match_jax(pairs, ring, kv):
    """Staggered admissions, lanes reused: the JAX scheduler's tokens, and
    the decode steps it took."""
    pair = pairs[(ring, kv)]
    stats, got = _run(pair.scheduler(), _prompts())
    assert got == pair.want
    assert stats.decode_steps > 0
    assert all(c.ttft_s >= 0 and c.t_done >= c.t_first_token
               for c in stats.completions)


@pytest.mark.parametrize("ring", [False, True], ids=["dense", "ring"])
def test_each_request_is_its_solo_generate(pairs, ring):
    pair = pairs[(ring, None)]
    assert [_solo(pair.port, p) for p in _prompts()] == pair.want


def test_eos_stops_one_sequence_not_the_batch(pairs):
    """Each completion stops at its own first EOS (inclusive); a request
    that never emits it runs to max_new_tokens."""
    pair = pairs[(True, None)]
    eos = pair.want[0][2]

    def trunc(seq):
        return seq[:seq.index(eos) + 1] if eos in seq else seq

    assert len(trunc(pair.want[0])) < NEW
    _, got = _run(pair.scheduler(eos_token_id=eos), _prompts())
    assert got == [trunc(w) for w in pair.want]


def test_streaming_callback_sees_every_token_in_order(pairs):
    pair = pairs[(True, None)]
    streamed = {}

    def cb(rid, token, done):
        streamed.setdefault(rid, []).append((token, done))

    stats, got = _run(pair.scheduler(), _prompts(), stream_callback=cb)
    assert got == pair.want
    for c in stats.completions:
        toks = [t for t, _ in streamed[c.request_id]]
        dones = [d for _, d in streamed[c.request_id]]
        assert toks == c.tokens
        assert dones == [False] * (len(toks) - 1) + [True]


def test_requests_submitted_while_running(pairs):
    """A stream callback submits the last requests mid-run: they are
    admitted into lanes freed later, with the same tokens."""
    pair = pairs[(False, None)]
    prompts = _prompts()
    sched = pair.scheduler()
    later = list(prompts[4:])

    def cb(rid, token, done):
        if done and later:
            sched.submit(later.pop(0), max_new_tokens=NEW)

    for p in prompts[:4]:
        sched.submit(p, max_new_tokens=NEW, stream_callback=cb)
    stats = sched.run()
    got = {c.request_id: c.tokens for c in stats.completions}
    assert not later
    assert [got[i] for i in range(len(prompts))] == pair.want


def test_submit_validation_follows_jax(pairs):
    pair = pairs[(False, None)]
    jsched = JaxScheduler(pair.jax, slots=2, prompt_bucket=8)
    sched = ContinuousBatchingScheduler(pair.port, slots=2, prompt_bucket=8)
    for args, kw in ((([],), {}), (([1, 2],), {"max_new_tokens": 0}),
                     (([1] * 250,), {"max_new_tokens": 32}),
                     (([1, 2],), {"replay_tokens": [3] * 8,
                                  "max_new_tokens": 8}),
                     (([1, 2],), {"replay_tokens": [3],
                                  "kv_handoff": (1, None)})):
        with pytest.raises(ValueError) as jerr:
            jsched.submit(*args, **kw)
        with pytest.raises(ValueError) as terr:
            sched.submit(*args, **kw)
        assert str(terr.value) == str(jerr.value)


def test_bucket_rules_follow_jax(pairs):
    """A ring model's bucket must be a multiple of its layout block; the
    default bucket is the block (ring) or 64 (dense)."""
    ring = pairs[(True, None)]
    with pytest.raises(ValueError, match="multiple of the") as terr:
        ContinuousBatchingScheduler(ring.port, slots=2, prompt_bucket=24)
    with pytest.raises(ValueError) as jerr:
        JaxScheduler(ring.jax, slots=2, prompt_bucket=24)
    assert str(terr.value) == str(jerr.value)
    assert ContinuousBatchingScheduler(ring.port).prompt_bucket == 16
    dense = pairs[(False, None)]
    assert ContinuousBatchingScheduler(dense.port).prompt_bucket == 64
    for bad in ({"slots": 0}, {"max_pending": 0}):
        with pytest.raises(ValueError):
            ContinuousBatchingScheduler(dense.port, **bad)


def test_bounded_queue_and_shedding_are_typed(pairs):
    """``max_pending`` (QueueFullError), an admission controller
    (RequestShedError), a spent deadline (DeadlineExceededError) and drain
    (DrainingError): each counted, the reject callback fired first, the
    request never queued."""
    pair = pairs[(False, None)]
    rejected = []

    class Shed:
        def decide(self, queue_depth, slots):
            return queue_depth < 1, "synthetic overload"

    sched = ContinuousBatchingScheduler(
        pair.port, slots=2, prompt_bucket=8, max_pending=2,
        admission_controller=Shed(),
        reject_callback=lambda rid, reason: rejected.append(reason))
    sched.submit([1, 2, 3])
    with pytest.raises(RequestShedError) as err:
        sched.submit([4, 5])
    assert err.value.reason == "slo_shed"
    sched.admission_controller = None
    sched.submit([4, 5])
    with pytest.raises(QueueFullError) as err:
        sched.submit([6])
    assert err.value.reason == "queue_full"
    sched.max_pending = None
    with pytest.raises(DeadlineExceededError):
        sched.submit([6], deadline_s=0)
    sched.begin_drain("test")
    with pytest.raises(DrainingError):
        sched.submit([6])
    assert rejected == ["slo_shed", "queue_full", "deadline", "draining"]
    assert sched.shed_count == 4 and sched.deadline_shed_count == 1
    assert len(sched._pending) == 2
    # draining: nothing is admitted, the queue stays for the hand-off
    stats = sched.run()
    assert stats.completions == [] and len(sched._pending) == 2


def test_expired_deadline_is_shed_from_the_queue(pairs):
    pair = pairs[(False, None)]
    sched = ContinuousBatchingScheduler(pair.port, slots=1, prompt_bucket=8)
    sched.submit([1, 2, 3], max_new_tokens=2)
    sched.submit([4, 5], max_new_tokens=2, deadline_s=1e-9)
    stats = sched.run()
    assert [c.request_id for c in stats.completions] == [0]
    assert sched.deadline_shed_count == 1


def test_replay_and_handoff_tokens_identical(pairs):
    """A failover replay continues a request from the tokens it emitted
    (prompt at its bucket, then the emitted tokens as continuation passes);
    a hand-off splices a prefill made elsewhere (``kv_handoff``). Both give
    the uninterrupted run's tokens (JAX scheduler.py :94-120, :697-716)."""
    pair = pairs[(True, None)]
    prompts = _prompts()
    sched = pair.scheduler()
    for p, w in zip(prompts, pair.want):
        sched.submit(p, max_new_tokens=NEW, replay_tokens=w[:3])
    stats = sched.run()
    got = {c.request_id: c.tokens for c in stats.completions}
    assert [got[i] for i in range(len(prompts))] == pair.want

    eng = pair.port
    handed = []
    for p in prompts:
        ids, mask = sched._padded(Request(prompt=p))
        logits, cache = eng._chunked_prefill(torch.from_numpy(ids),
                                             torch.from_numpy(mask))
        handed.append((int(logits.argmax(-1)[0]), cache.clone()))
    sched = pair.scheduler()
    for p, h in zip(prompts, handed):
        sched.submit(p, max_new_tokens=NEW, kv_handoff=h)
    stats = sched.run()
    got = {c.request_id: c.tokens for c in stats.completions}
    assert [got[i] for i in range(len(prompts))] == pair.want


@pytest.mark.parametrize("ring", [False, True], ids=["dense", "ring"])
def test_kv_cache_stats_int8_against_compute(pairs, ring):
    """``resident_bytes`` is what the lane cache holds; int8 keys and values
    with f32 scales against f32 ones (the unquantized twin of the int8
    cache is the f32 cache), and the keys', values' and scales' bytes are
    JAX's."""
    full = pairs[(ring, None)].scheduler().kv_cache_stats(
        hbm_override_gib=16.0)
    sched8 = pairs[(ring, "int8")].scheduler()
    int8 = sched8.kv_cache_stats(hbm_override_gib=16.0)
    cache = pairs[(ring, "int8")].port._decoder(3).cache
    assert int8["resident_bytes"] == cache.nbytes()
    assert int8["unquantized_bytes"] == full["resident_bytes"]
    assert int8["kv_cache_dtype"] == "int8"
    assert full["kv_cache_dtype"] == "compute"
    assert int8["compression_ratio"] > 2.0
    assert int8["lanes_at_hbm_budget"] > int8["lanes"]
    assert int8["hbm_bytes"] == 16 << 30
    kv = sum(t.numel() * t.element_size() for t in
             cache.key + cache.value + cache.key_scale + cache.value_scale)
    S = cache.valid.shape[1]
    want = 2 * BASE["n_layer"] * 3 * S * BASE["n_head"] * (16 + 4)
    assert kv == want
    assert "kv_cache" in sched8.frontdoor_stats()


@pytest.mark.parametrize("ring", [False, True], ids=["dense", "ring"])
def test_free_lanes_are_emptied_before_they_pass_the_capacity(ring):
    """A lane freed early keeps decoding garbage while a long request runs
    on; where JAX's writes past the cache are dropped, the port empties the
    free lane's row first (``KVCache.reset_rows``), and the long request's
    tokens are its solo ``generate``'s. The ring case has a position table,
    so it is capped too."""
    fields = dict(n_positions=64)
    tm = tlm.GPT(tlm.GPTConfig(**{**BASE, **fields}, dtype=torch.float32))
    if ring:
        tm = apply_sparse_attention(tm, WINDOW)
    port = deepspeed_tpu_torch.init_inference(tm, dtype="fp32", device="cpu",
                                              seed=3)
    prompts = _prompts(seed=4, lengths=(10, 30))
    sched = ContinuousBatchingScheduler(port, slots=2, prompt_bucket=16)
    sched.submit(prompts[0], max_new_tokens=40)
    sched.submit(prompts[1], max_new_tokens=2)
    stats = sched.run()
    got = {c.request_id: c.tokens for c in stats.completions}
    assert got[0] == _solo(port, prompts[0], 40, min_len=16)
    assert got[1] == _solo(port, prompts[1], 2, min_len=16)
    cache = port._decoder(2).cache
    assert cache.lengths.max() <= fields["n_positions"]
