"""The port's shared-prefix KV cache against the JAX package's.

Mirrors ``tests/unit/test_serving_frontdoor.py:106-187`` (the cache's
policy on fake trees: candidates, lookup, promotion, LRU over a byte
budget, bounded counters; here each call is made on the JAX cache and the
port's side by side and must answer alike), :376-413 (a prefill split at an
unaligned cut matches the full forward at every position) and :416-520
(prefix-spliced decode token-identical to cold admissions, to solo
``generate`` and to the JAX scheduler with its prefix cache, on the ring
and the dense cache, and under eviction churn). Weights come from the JAX
engines (f32 on the CPU) through ``gpt_state_dict_from_jax``.
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
from deepspeed_tpu.serving import PrefixCache as JaxPrefixCache
from deepspeed_tpu.serving import PrefixCacheConfig as JaxPrefixCacheConfig
from deepspeed_tpu_torch.inference.engine import continuation_chunk_spans
from deepspeed_tpu_torch.inference.scheduler import \
    ContinuousBatchingScheduler
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import \
    apply_sparse_attention
from deepspeed_tpu_torch.serving import PrefixCache, PrefixCacheConfig
from deepspeed_tpu_torch.serving.prefix_cache import _tree_nbytes

torch.set_num_threads(2)

# block 16, 3 window blocks: a 32-slot ring
WINDOW = {"mode": "local_sliding_window", "block": 16,
          "num_sliding_window_blocks": 3}
BASE = dict(vocab_size=128, n_positions=256, n_embd=64, n_layer=2, n_head=4)
RING_FIELDS = dict(rotary=True, learned_positions=False)


def _fake_tree(nbytes):
    return {"k": np.zeros(nbytes // 4, np.float32)}


def _cols(pads, tokens):
    return tuple([-1] * pads + list(tokens))


class _Both:
    """The JAX prefix cache and the port's, driven with the same calls; each
    call's answers must agree (entries compared by key and length)."""

    def __init__(self, **kw):
        kw.setdefault("align", 16)
        kw.setdefault("budget_bytes", 1 << 20)
        self.jax = JaxPrefixCache(JaxPrefixCacheConfig(**kw))
        self.port = PrefixCache(PrefixCacheConfig(**kw))

    def __getattr__(self, name):
        def call(*args, **kw):
            want = getattr(self.jax, name)(*args, **kw)
            got = getattr(self.port, name)(*args, **kw)
            if hasattr(want, "key"):
                assert (got.key, got.length, got.refs, got.nbytes) == (
                    want.key, want.length, want.refs, want.nbytes)
                return got, want
            assert got == want, (name, got, want)
            return got
        return call

    def release(self, pair):
        self.port.release(pair[0])
        self.jax.release(pair[1])

    def stats(self):
        assert self.port.stats() == self.jax.stats()
        return self.port.stats()


def test_candidates_respect_pads_align_and_limit():
    pc = _Both()
    cols = _cols(3, range(60))
    assert pc._candidate_lengths(cols, limit=62) == [16, 32, 48]
    assert _Both(min_prefix_tokens=20)._candidate_lengths(
        cols, limit=62) == [32, 48]
    assert pc._candidate_lengths(cols, limit=15) == []


def test_lookup_returns_longest_and_pins():
    pc = _Both()
    cols = _cols(0, range(100))
    pc.insert(cols[:16], _fake_tree(1024))
    pc.insert(cols[:48], _fake_tree(1024))
    got = pc.lookup(cols, limit=99, request_id=7)
    assert got[0].length == 48 and got[0].refs == 1
    pc.release(got)
    assert got[0].refs == 0
    assert pc.lookup(_cols(0, range(1, 50)), limit=40) is None
    assert pc.stats()["hits"] == 1 and pc.stats()["misses"] == 1


def test_promotion_waits_for_popularity_and_finds_the_shared_cut():
    pc = _Both(promote_after=2)
    cols = _cols(0, range(64))
    assert pc.promotion_target(cols, limit=63) is None
    assert pc.promotion_target(cols, limit=63) == 48
    pc.insert(cols[:48], _fake_tree(256))
    assert pc.promotion_target(cols, limit=63, have=48) is None
    # two prompts sharing 32 columns promote at 32
    pc = _Both(promote_after=2)
    a = _cols(0, list(range(32)) + [100] * 32)
    b = _cols(0, list(range(32)) + [101] * 32)
    assert pc.promotion_target(a, limit=63) is None
    assert pc.promotion_target(b, limit=63) == 32


def test_lru_eviction_respects_pins_and_budget():
    pc = _Both(budget_bytes=3000)
    k1, k2 = _cols(0, range(16)), _cols(0, range(100, 116))
    assert pc.insert(k1, _fake_tree(1024))
    assert pc.insert(k2, _fake_tree(1024))
    e1 = pc.lookup(_cols(0, range(32)), limit=31)
    assert e1[0].key == k1
    # 2048 needs both residents gone, but k1 is pinned: only k2 goes, and
    # the insert fails
    assert not pc.insert(_cols(0, range(200, 216)), _fake_tree(2048))
    pc.release(e1)
    assert pc.insert(_cols(0, range(200, 216)), _fake_tree(2048))
    assert k1 not in pc.port._entries
    assert pc.stats()["evictions"] == 2
    assert pc.port.bytes_used <= pc.port.budget_bytes


def test_oversized_insert_is_dropped_and_counters_bounded():
    pc = _Both(budget_bytes=512)
    assert not pc.insert(_cols(0, range(16)), _fake_tree(1024))
    assert pc.stats()["insert_skips"] == 1 and len(pc.port) == 0
    pc = _Both(counter_capacity=8)
    for i in range(40):
        pc.promotion_target(_cols(0, range(i, i + 32)), limit=31)
    assert len(pc.port._counts) == len(pc.jax._counts) <= 8


def test_config_validation_and_budget():
    for bad in ({"align": 0}, {"promote_after": 0}):
        with pytest.raises(ValueError):
            PrefixCacheConfig(**bad)
    # no card: the fallback budget, as JAX's on a backend with no HBM figure
    assert PrefixCache(device="cpu").budget_bytes == 256 << 20
    cache = tlm.kv_cache(tlm.GPTConfig(**BASE, dtype=torch.float32), 1,
                         "cpu")
    assert _tree_nbytes(cache) == cache.nbytes() == sum(
        t.numel() * t.element_size() for t in cache.tensors())


# -- on models ------------------------------------------------------------
def _pair(ring):
    fields = RING_FIELDS if ring else {}
    jm = jlm.GPT(jlm.GPTConfig(**BASE, dtype=jnp.float32, **fields))
    tm = tlm.GPT(tlm.GPTConfig(**BASE, dtype=torch.float32, **fields))
    if ring:
        jm, tm = jax_sparse(jm, WINDOW), apply_sparse_attention(tm, WINDOW)
    jeng = JaxEngine(jm, {"dtype": "fp32"}, seed=0)
    # the weights alone (its init at a length the window's layout takes)
    jeng._materialize(jnp.zeros((1, 48), jnp.int32))
    sd = gpt_state_dict_from_jax(jax.device_get(jeng.params), tm.config)
    port = deepspeed_tpu_torch.init_inference(tm, dtype="fp32", device="cpu",
                                              state_dict=sd)
    return jeng, port


@pytest.fixture(scope="module")
def engines():
    return {ring: _pair(ring) for ring in (False, True)}


@pytest.mark.parametrize("ring,cut,T", [(True, 37, 96), (False, 19, 48)],
                         ids=["ring", "dense"])
def test_continuation_at_an_unaligned_cut_every_position(engines, ring, cut,
                                                         T):
    """Prefill ``[0, cut)`` then continue to T (``continuation_chunk_spans``
    on both sides of the cut): every position's logits are the full
    forward's (atol 2e-4, rtol 1e-3: the JAX test's bound; the paths sum in
    different orders)."""
    _, port = engines[ring]
    cfg = port.module.config
    ids = torch.from_numpy(np.random.RandomState(3 + (not ring)).randint(
        0, 128, size=(1, T)))
    full = port(ids)
    cache = tlm.kv_cache(cfg, 1, "cpu")
    pieces = []
    spans = (continuation_chunk_spans(cfg, 0, cut)
             + continuation_chunk_spans(cfg, cut, T))
    assert (len(spans) > 2) == ring
    with torch.inference_mode():
        for s, e in spans:
            pieces.append(port.module(ids[:, s:e], decode=True,
                                      cache=cache)[0])
    np.testing.assert_allclose(torch.cat(pieces, dim=1).numpy(),
                               full.numpy(), atol=2e-4, rtol=1e-3)


def _solo(engine, prompt, new):
    L = max(48, -(-len(prompt) // 16) * 16)
    ids = np.zeros((1, L), np.int64)
    mask = np.zeros((1, L), bool)
    ids[0, :len(prompt)] = prompt
    mask[0, :len(prompt)] = True
    return engine.generate(ids, max_new_tokens=new,
                           attention_mask=torch.from_numpy(mask))[0].tolist()


def _run(sched, prompts, new):
    for p in prompts:
        sched.submit(p, max_new_tokens=new)
    got = {c.request_id: c.tokens for c in sched.run().completions}
    return [got[i] for i in range(len(prompts))]


def _shared(seed, prefix_len, suffixes):
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(1, 128, size=prefix_len)]
    return [prefix + [int(t) for t in rng.integers(1, 128, size=n)]
            for n in suffixes]


@pytest.mark.parametrize("case", ["ring", "ring_past_capacity", "dense"])
def test_prefix_hits_match_cold_solo_and_jax(engines, case):
    """Prompts sharing a padded prefix (suffix lengths congruent mod the
    bucket): served through the prefix cache, token-identical to cold
    admissions, to each prompt's solo ``generate`` and to the JAX
    scheduler with its prefix cache; the hits are counted."""
    ring = case != "dense"
    jeng, port = engines[ring]
    if case == "ring":
        prompts, new, promote = _shared(0, 40, (9, 25, 41, 9, 25)), 6, 1
    elif case == "ring_past_capacity":
        # the prefix alone is 2x the ring; a second admission promotes at
        # the longest shared cut
        prompts, new, promote = _shared(1, 64, (30, 14, 30)), 5, 2
    else:
        prompts, new, promote = _shared(2, 20, (1, 9, 17, 1)), 6, 1
    bucket = 16 if ring else 8
    align = bucket

    def jax_run():
        pc = JaxPrefixCache(JaxPrefixCacheConfig(align=align,
                                                 promote_after=promote))
        return _run(JaxScheduler(jeng, slots=2, prompt_bucket=bucket,
                                 prefix_cache=pc), prompts, new)

    pc = PrefixCache(PrefixCacheConfig(align=align, promote_after=promote))
    warm = _run(ContinuousBatchingScheduler(
        port, slots=2, prompt_bucket=bucket, prefix_cache=pc), prompts, new)
    cold = _run(ContinuousBatchingScheduler(port, slots=2,
                                            prompt_bucket=bucket),
                prompts, new)
    assert warm == cold == jax_run()
    assert warm == [_solo(port, p, new) for p in prompts]
    st = pc.stats()
    assert st["insertions"] >= 1
    assert st["hits"] >= (1 if case == "ring_past_capacity" else 2)


def test_byte_pressure_evicts_but_stays_exact(engines):
    """A budget that holds about one entry churns between two hot prefixes;
    pinned entries hold and decode stays exact."""
    _, port = engines[True]
    rng = np.random.default_rng(3)
    p1 = [int(t) for t in rng.integers(1, 128, size=40)]
    p2 = [int(t) for t in rng.integers(1, 128, size=40)]
    prompts = []
    for _ in range(2):
        prompts.append(p1 + [int(t) for t in rng.integers(1, 128, size=9)])
        prompts.append(p2 + [int(t) for t in rng.integers(1, 128, size=9)])
    cold = _run(ContinuousBatchingScheduler(port, slots=2), prompts, 5)
    probe = PrefixCache(PrefixCacheConfig(align=16, promote_after=1))
    assert _run(ContinuousBatchingScheduler(port, slots=2,
                                            prefix_cache=probe),
                prompts[:1], 5) == cold[:1]
    one = probe.stats()["bytes_used"]
    assert one == port._decoder(1).cache.nbytes()
    tight = PrefixCache(PrefixCacheConfig(align=16, promote_after=1,
                                          budget_bytes=int(one * 1.2)))
    assert _run(ContinuousBatchingScheduler(port, slots=2,
                                            prefix_cache=tight),
                prompts, 5) == cold
    assert tight.stats()["evictions"] >= 1
