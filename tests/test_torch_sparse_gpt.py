"""The port's GPT block-sparse route and ring KV cache against the JAX
package's.

Small GPTs (2 layers, width 64, 4 heads, layout block 16), f32, the flax
weights carried over by ``gpt_state_dict_from_jax``, the same numpy ids on
both sides. Training: logits to atol 1e-4 and the loss and every gradient
to 1e-5 of the gradient's largest entry (``test_torch_llama.py``'s
bounds), under a causal sliding window, a causal longformer with a leading
global block (rotary), a causal BigBird (grouped-query) and a causal
``fixed`` layout; the port's "pallas" route runs the plain versions of
B5-B7 (CPU tensors) against JAX's Pallas kernels in interpret mode, its
"gather" route against JAX's. Decode mirrors the JAX package's
``TestSparseRingKVCache`` and ``TestDemandedRingDeclines``
(``tests/unit/test_inference.py:420-760``): T 96 over a 32-slot ring
(block 16, one past window block), several wraparounds, each step's logits
against JAX's decode and against the training sparse forward (atol 1e-4),
and the ring's contents against JAX's cache. The prefill spans are held to
JAX's values over a grid (``tests/unit/test_serving.py:39-48``,
``test_serving_frontdoor.py:84-89``); the engines to JAX's greedy tokens
and training steps.
"""

import dataclasses
import os
import sys
import logging
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import engine as jinf
from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.ops.sparse_attention import sparse_attention_utils as jutils
from deepspeed_tpu.parallel.mesh import MeshTopology, reset_default_topology
from deepspeed_tpu_torch.inference import engine as tinf
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import (flatten_jax_tree,
                                                           gpt_state_dict_from_jax)
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention_utils as tutils
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as tssa
from deepspeed_tpu_torch.utils import logging as tlog

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4
GRAD_RTOL = 1e-5
SMALL = dict(vocab_size=128, n_positions=256, n_embd=64, n_layer=2, n_head=4)
# block 16, num_sliding_window_blocks 3: one past block, a 32-slot ring
WINDOW = {"mode": "local_sliding_window", "block": 16,
          "num_sliding_window_blocks": 3}
LONGFORMER = {"mode": "bslongformer", "block": 16,
              "num_sliding_window_blocks": 3, "attention": "unidirectional"}
BIGBIRD = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
           "num_sliding_window_blocks": 3, "num_global_blocks": 1,
           "attention": "unidirectional"}
FIXED = {"mode": "fixed", "block": 16, "num_local_blocks": 2,
         "attention": "unidirectional"}
ROTARY = dict(rotary=True, learned_positions=False)
T = 64


def _configs(sparse, kernel=None, **over):
    """(flax config, port config) of SMALL with the ``sparse`` layout on
    ``kernel`` (None: the layout's default, "gather")."""
    block = dict(sparse, kernel=kernel) if kernel else dict(sparse)
    fields = dict(SMALL, **over)
    jcfg = jlm.GPTConfig(**fields, dtype=jnp.float32,
                         sparse_attention=jutils.get_sparse_attention_config(
                             dict(block), fields["n_head"]))
    tcfg = tlm.GPTConfig(**fields, dtype=torch.float32,
                         sparse_attention=tutils.get_sparse_attention_config(
                             dict(block), fields["n_head"]))
    return jcfg, tcfg


def _pair(sparse, kernel=None, train=False, seed=0, **over):
    """(jax model, jax params, port model) on one set of weights."""
    jcfg, tcfg = _configs(sparse, kernel, **over)
    jmodel = jlm.GPT(jcfg)
    params = jax.device_get(cached_init(jmodel, seed, jnp.zeros((1, T), jnp.int32),
        deterministic=True)["params"])
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(gpt_state_dict_from_jax(params, tcfg), assign=True)
    tmodel.train(train)
    for prm in tmodel.parameters():
        prm.requires_grad_(train)
    return jmodel, params, tmodel


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], size=(b, t)).astype(np.int32)


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= GRAD_RTOL * scale + 1e-9, f"{name}: {err} of {scale}"


# layout, kernel on both sides, extra config fields
TRAIN_CASES = {
    "window_pallas": (WINDOW, "pallas", {}),
    "window_gather": (WINDOW, "gather", {}),
    "window_pallas_remat": (WINDOW, "pallas", {"remat": True}),
    "longformer_rotary_pallas": (LONGFORMER, "pallas", ROTARY),
    "longformer_rotary_gather": (LONGFORMER, "gather", ROTARY),
    "bigbird_gqa_pallas": (BIGBIRD, "pallas", {"n_kv_head": 2}),
    "bigbird_gqa_gather": (BIGBIRD, "gather", {"n_kv_head": 2}),
    "fixed_pallas": (FIXED, "pallas", {}),
    "fixed_gather": (FIXED, "gather", {}),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_logits_loss_and_every_gradient_match_jax(case, monkeypatch):
    sparse, kernel, over = TRAIN_CASES[case]
    jmodel, params, tmodel = _pair(sparse, kernel, train=True, **over)
    calls = []
    real = tssa.block_sparse_attention

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(tssa, "block_sparse_attention", counted)
    ids = _ids(2, T, seed=3)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   deterministic=True))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)

    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids),
                            labels=jnp.asarray(ids), deterministic=False)

    jl, jg = jax.value_and_grad(jloss)(params)
    tl = tmodel.train()(torch.from_numpy(ids).long(),
                        labels=torch.from_numpy(ids).long())
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= GRAD_RTOL * abs(float(jl))
    _assert_grads({n: p.grad for n, p in tmodel.named_parameters()},
                  gpt_state_dict_from_jax(jax.device_get(jg), tmodel.config))
    # the kernels' route is taken on every layer of each call (the
    # recompute of a remat layer calls it again); "gather" never
    per_call = SMALL["n_layer"] * (3 if over.get("remat") else 2)
    assert len(calls) == (per_call if kernel == "pallas" else 0)


def test_bridge_carries_a_sparse_tree_unchanged():
    """The route adds no parameter: a sparse GPT's flax tree is the dense
    one's, and the bridge gives the same state dict for both configs."""
    jcfg, tcfg = _configs(WINDOW, "pallas", **ROTARY)
    dense_j = dataclasses.replace(jcfg, sparse_attention=None)
    ids = jnp.zeros((1, T), jnp.int32)
    sparse_p = jax.device_get(cached_init(
        jlm.GPT(jcfg), 0, ids, deterministic=True)["params"])
    dense_p = jax.device_get(cached_init(
        jlm.GPT(dense_j), 0, ids, deterministic=True)["params"])
    assert jax.tree.structure(sparse_p) == jax.tree.structure(dense_p)
    sd = gpt_state_dict_from_jax(sparse_p, tcfg)
    dense_sd = gpt_state_dict_from_jax(
        dense_p, dataclasses.replace(tcfg, sparse_attention=None))
    assert set(sd) == set(tlm.GPT(tcfg).state_dict()) == set(dense_sd)
    for name, w in sd.items():
        assert torch.equal(w, dense_sd[name]), name
    assert [n for n, _ in flatten_jax_tree(sparse_p)] == \
        [n for n, _ in flatten_jax_tree(dense_p)]


def test_segment_ids_with_a_sparse_layout_raise_as_in_jax():
    jmodel, params, tmodel = _pair(WINDOW)
    ids = _ids(1, T)
    seg = np.ones_like(ids)
    msg = "segment_ids with a block-sparse layout"
    with pytest.raises(NotImplementedError, match=msg):
        jmodel.apply({"params": params}, jnp.asarray(ids),
                     segment_ids=jnp.asarray(seg), deterministic=True)
    with pytest.raises(NotImplementedError, match=msg):
        tmodel(torch.from_numpy(ids).long(),
               segment_ids=torch.from_numpy(seg).long())


# ---------------------------------------------------------------------------
# decode: the ring cache
# ---------------------------------------------------------------------------
DECODE_LAYOUTS = {"window": (WINDOW, {}), "longformer": (LONGFORMER, {}),
                  "window_rotary": (WINDOW, ROTARY),
                  "window_gqa": (WINDOW, {"n_kv_head": 2})}


@pytest.mark.parametrize("layout", sorted(DECODE_LAYOUTS))
def test_ring_decode_matches_jax_and_the_training_forward(layout):
    """Prefill 24 tokens, then decode one by one to 96 (a 32-slot ring, 48
    with the longformer's global block): each step's logits equal JAX's
    decode and the training sparse forward's at that position, and the
    ring holds what JAX's holds."""
    sparse, over = DECODE_LAYOUTS[layout]
    jmodel, params, tmodel = _pair(sparse, **over)
    ids = _ids(2, 96, seed=11)
    with torch.no_grad():
        full = tmodel(torch.from_numpy(ids).long()).numpy()
    jfull = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                    deterministic=True))
    np.testing.assert_allclose(full, jfull, atol=ATOL, rtol=0)

    @jax.jit
    def step_fn(params, cache, tok):
        return jmodel.apply({"params": params, "cache": cache}, tok,
                            deterministic=True, decode=True,
                            mutable=["cache"])

    pre_t = 24
    jpre, jcache = jmodel.apply({"params": params}, jnp.asarray(ids[:, :pre_t]),
                                deterministic=True, decode=True,
                                mutable=["cache"])
    jcache = jcache["cache"]
    with torch.no_grad():
        tpre, cache = tmodel(torch.from_numpy(ids[:, :pre_t]).long(),
                             decode=True)
    assert isinstance(cache, tlm.RingKVCache)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tpre.numpy(), full[:, :pre_t], atol=ATOL,
                               rtol=0)
    for t in range(pre_t, 96):
        jstep, jcache = step_fn(params, jcache, jnp.asarray(ids[:, t:t + 1]))
        jcache = jcache["cache"]
        with torch.no_grad():
            tstep, cache = tmodel(torch.from_numpy(ids[:, t:t + 1]).long(),
                                  decode=True, cache=cache)
        np.testing.assert_allclose(tstep[:, 0].numpy(), np.asarray(jstep)[:, 0],
                                   atol=ATOL, rtol=0, err_msg=f"position {t}")
        np.testing.assert_allclose(tstep[:, 0].numpy(), full[:, t], atol=ATOL,
                                   rtol=0, err_msg=f"position {t}")
    ring = jcache["h"]["block"]["attn"]
    np.testing.assert_array_equal(cache.slot_pos.numpy(),
                                  np.asarray(ring["slot_pos"][0]))
    np.testing.assert_array_equal(cache.valid.numpy(),
                                  np.asarray(ring["valid"][0]))
    for i in range(SMALL["n_layer"]):
        np.testing.assert_allclose(cache.key[i].numpy(),
                                   np.asarray(ring["cached_key"][i]),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(cache.value[i].numpy(),
                                   np.asarray(ring["cached_value"][i]),
                                   atol=ATOL, rtol=0)
    assert cache.index.tolist() == [96, 96] == \
        np.asarray(ring["cache_index"][0]).tolist()


def _jax_slot_dims(jmodel, ids):
    vs = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), ids,
                                            deterministic=True, decode=True))
    return {v.shape[-3] for p, v in jax.tree_util.tree_flatten_with_path(
        vs["cache"])[0] if "cached_key" in jax.tree_util.keystr(p)}


def test_cache_is_ring_sized():
    """32 slots, not n_positions' 1024, as JAX's cache."""
    jcfg, tcfg = _configs(WINDOW, n_positions=1024)
    assert _jax_slot_dims(jlm.GPT(jcfg), jnp.zeros((1, 8), jnp.int32)) == {32}
    cache = tlm.kv_cache(tcfg, 2, "cpu")
    assert isinstance(cache, tlm.RingKVCache)
    assert {tuple(k.shape) for k in cache.key + cache.value} == \
        {(2, 32, SMALL["n_head"], 16)}
    assert cache.slot_pos.shape == cache.valid.shape == (2, 32)
    # slack blocks are storage only
    slack = tlm.kv_cache(dataclasses.replace(tcfg, kv_cache_slack_blocks=1),
                         1, "cpu")
    assert slack.key[0].shape[1] == 48 and slack.ring_len == 48


def _port_engine(sparse, params=None, seed=0, **over):
    tcfg = _configs(sparse, **over)[1]
    sd = None if params is None else gpt_state_dict_from_jax(params, tcfg)
    return deepspeed_tpu_torch.init_inference(
        tutils.apply_sparse_attention(
            tlm.GPT(dataclasses.replace(tcfg, sparse_attention=None)),
            dict(sparse)),
        dtype="fp32", device="cpu", state_dict=sd, seed=seed)


@pytest.fixture(scope="module")
def served():
    """The JAX engine and the port's, on the JAX engine's weights, for a
    window model (its 32-slot ring is shorter than the 64-token prompt)."""
    reset_default_topology()
    jeng = deepspeed_tpu.init_inference(
        jutils.apply_sparse_attention(
            jlm.GPT(jlm.GPTConfig(**SMALL, dtype=jnp.float32)), dict(WINDOW)),
        dtype="fp32", seed=0)
    ids = _ids(2, 64, seed=12)
    jlogits = np.asarray(jeng(jnp.asarray(ids)))
    teng = _port_engine(WINDOW, jax.device_get(jeng.params))
    return jeng, teng, ids, jlogits


def test_engine_forward_matches_jax(served):
    _, teng, ids, jlogits = served
    np.testing.assert_allclose(teng(ids).numpy(), jlogits, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ragged", [False, True])
def test_generate_past_the_ring_matches_jax(served, ragged):
    """A 64-token prompt over a 32-slot ring prefills in 16-token spans on
    both sides; greedy tokens are identical (ragged: right-padded prompts
    of 64 and 40 tokens, left-aligned by both engines)."""
    jeng, teng, ids, _ = served
    mask = None
    if ragged:
        mask = np.arange(64)[None, :] < np.array([64, 40])[:, None]
    want = np.asarray(jeng.generate(
        jnp.asarray(ids), max_new_tokens=24,
        attention_mask=None if mask is None else jnp.asarray(mask)))
    cache = teng._decoder(2)[0]
    got = teng.generate(ids, max_new_tokens=24,
                        attention_mask=None if mask is None
                        else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    assert isinstance(cache, tlm.RingKVCache) and cache.key[0].shape[1] == 32


def test_ragged_ring_decode_matches_solo():
    """Two prompts (48 and 64 tokens) decoded together equal each decoded
    alone."""
    eng = _port_engine(WINDOW)
    rng = np.random.RandomState(12)
    lens = [48, 64]
    prompts = [rng.randint(0, 128, size=(1, n)) for n in lens]
    singles = [eng.generate(p, max_new_tokens=40).numpy() for p in prompts]
    ids = np.zeros((2, 64), np.int64)
    mask = np.zeros((2, 64), bool)
    for b, p in enumerate(prompts):
        ids[b, :lens[b]] = p[0]
        mask[b, :lens[b]] = True
    batched = eng.generate(ids, max_new_tokens=40,
                           attention_mask=torch.from_numpy(mask)).numpy()
    for b in range(2):
        np.testing.assert_array_equal(batched[b], singles[b][0])


def _warnings_of(fn):
    """``fn()`` with the port's logger heard: its WARNING messages."""
    tlog._warn_once_cached.cache_clear()
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    tlog.logger.addHandler(handler)
    try:
        out = fn()
    finally:
        tlog.logger.removeHandler(handler)
    return out, [r.getMessage() for r in records]


def test_bigbird_decodes_dense_with_the_warning():
    eng = _port_engine(BIGBIRD)
    ids = _ids(1, 48, seed=13)
    out, msgs = _warnings_of(lambda: eng.generate(ids, max_new_tokens=3))
    assert out.shape == (1, 3)
    assert any("DENSE" in m for m in msgs), msgs
    cache = eng._decoder(1)[0]
    assert type(cache) is tlm.KVCache
    assert cache.key[0].shape[1] == SMALL["n_positions"]
    # a ring model does not warn
    _, msgs = _warnings_of(lambda: _port_engine(WINDOW).generate(
        ids, max_new_tokens=3))
    assert not any("DENSE" in m for m in msgs), msgs


def test_streaming_decode_past_n_positions():
    """A rotary ring model streams: 48 + 100 tokens past n_positions 64
    give the tokens of the same weights at n_positions 4096; a model with
    a position table keeps the cap."""
    ids = _ids(1, 48, seed=15)
    small = _port_engine(LONGFORMER, n_positions=64, **ROTARY)
    toks = small.generate(ids, max_new_tokens=100)
    assert toks.shape == (1, 100)
    big = _port_engine(LONGFORMER, n_positions=4096, **ROTARY)
    np.testing.assert_array_equal(toks.numpy(),
                                  big.generate(ids, max_new_tokens=100).numpy())
    wpe = _port_engine(LONGFORMER, n_positions=64)
    with pytest.raises(ValueError, match="exceeds the KV cache"):
        wpe.generate(ids, max_new_tokens=100)


def test_prefill_guard_raises_as_in_jax():
    """A decode pass longer than the ring raises the JAX model's error."""
    jmodel, params, tmodel = _pair(WINDOW)
    ids = _ids(1, 48)
    with pytest.raises(ValueError, match="ring KV prefill got 48 tokens"):
        jmodel.apply({"params": params}, jnp.asarray(ids), deterministic=True,
                     decode=True, mutable=["cache"])
    with pytest.raises(ValueError, match="ring KV prefill got 48 tokens"):
        tmodel(torch.from_numpy(ids).long(), decode=True)


def _cfg_ns(sc, kv, n_positions):
    from types import SimpleNamespace

    return SimpleNamespace(sparse_attention=sc, sparse_kv_cache=kv,
                           n_positions=n_positions)


def _longformers():
    return (jutils.get_sparse_attention_config(dict(LONGFORMER), 4),
            tutils.get_sparse_attention_config(dict(LONGFORMER), 4))


def test_sparse_kv_cache_true_rejects_bigbird():
    for utils, mod, dt in ((jutils, jlm, jnp.float32),
                           (tutils, tlm, torch.float32)):
        sc = utils.get_sparse_attention_config(dict(BIGBIRD), 4)
        with pytest.raises(ValueError, match="ring-expressible"):
            mod.GPTConfig(**SMALL, dtype=dt, sparse_attention=sc,
                          sparse_kv_cache=True)


def test_demanded_ring_engages_even_when_oversized():
    """Ring 16 + (1 + 1) * 16 = 48 >= n_positions 32: "auto" would
    decline, True engages, silently."""
    for utils, sc in zip((jutils, tutils), _longformers()):
        n0 = len(utils.RING_DECLINES)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert utils.ring_engaged(_cfg_ns(sc, True, 32)) == (1, 16, 16)
        assert len(utils.RING_DECLINES) == n0


def test_inexpressible_layout_warns_with_its_reason():
    block = dict(LONGFORMER, attention="bidirectional")
    for utils in (jutils, tutils):
        sc = utils.get_sparse_attention_config(dict(block), 4)
        n0 = len(utils.RING_DECLINES)
        with pytest.warns(RuntimeWarning, match="no ring expression"):
            assert utils.ring_engaged(_cfg_ns(sc, True, 4096)) is None
        assert len(utils.RING_DECLINES) == n0 + 1
    assert tutils.RING_DECLINES[-1] == jutils.RING_DECLINES[-1]


def test_auto_decline_stays_silent_and_an_engaged_ring_does_not_warn():
    for utils, sc in zip((jutils, tutils), _longformers()):
        n0 = len(utils.RING_DECLINES)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert utils.ring_engaged(_cfg_ns(sc, "auto", 32)) is None
            assert utils.ring_engaged(_cfg_ns(sc, True, 4096)) == (1, 16, 16)
            assert utils.ring_engaged(_cfg_ns(sc, "auto", 4096)) == (1, 16, 16)
        assert len(utils.RING_DECLINES) == n0


# ---------------------------------------------------------------------------
# prefill spans
# ---------------------------------------------------------------------------
SPAN_LAYOUTS = {"dense": None, "window": WINDOW, "longformer": LONGFORMER,
                "bigbird": BIGBIRD}


@pytest.mark.parametrize("slack", [0, 1, 2])
@pytest.mark.parametrize("layout", sorted(SPAN_LAYOUTS))
def test_chunk_spans_match_jax(layout, slack):
    sparse = SPAN_LAYOUTS[layout]
    if sparse is None:
        jcfg = jlm.GPTConfig(**SMALL, kv_cache_slack_blocks=slack)
        tcfg = tlm.GPTConfig(**SMALL, kv_cache_slack_blocks=slack)
    else:
        jcfg, tcfg = _configs(sparse, kv_cache_slack_blocks=slack)
    for t in (1, 15, 16, 17, 31, 32, 33, 47, 48, 49, 64, 90, 200):
        assert tinf.prefill_chunk_spans(tcfg, t) == \
            jinf.prefill_chunk_spans(jcfg, t), t
    for start in (0, 1, 5, 15, 16, 31, 37, 48):
        for end in (start + 1, 32, 33, 48, 49, 64, 96, 130):
            if end <= start:
                continue
            assert tinf.continuation_chunk_spans(tcfg, start, end) == \
                jinf.continuation_chunk_spans(jcfg, start, end), (start, end)
    for bad in ((5, 5), (-1, 3), (7, 2)):
        with pytest.raises(ValueError, match="bad continuation span"):
            tinf.continuation_chunk_spans(tcfg, *bad)


def test_long_prompt_spans_are_single_blocks():
    tcfg = _configs(WINDOW)[1]
    assert tinf.prefill_chunk_spans(tcfg, 32) is None
    spans = tinf.prefill_chunk_spans(tcfg, 90)
    assert spans[0] == (0, 16) and spans[-1] == (80, 90)
    assert [s for s, _ in spans[1:]] == [e for _, e in spans[:-1]]
    assert all(e - s <= 16 and s % 16 == 0 for s, e in spans)


# ---------------------------------------------------------------------------
# training through the engine
# ---------------------------------------------------------------------------
LR = 1e-3


@pytest.mark.parametrize("kernel", ["pallas", "gather"])
def test_engine_training_matches_jax(kernel):
    """``initialize`` with a ``sparse_attention`` block over a GPT: the
    engine rebuilds the model onto the route; 3 steps against the JAX
    engine's, losses to 1e-5 relative and parameters to 2e-5 (the key
    third of c_attn.bias to 3 * 2 * lr: its gradient is zero in exact
    arithmetic)."""
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": LR, "weight_decay": 0.1}},
          "steps_per_print": 10 ** 9,
          "sparse_attention": dict(WINDOW, kernel=kernel)}
    reset_default_topology()
    jcfg = jlm.GPTConfig(**SMALL, dtype=jnp.float32)
    jmodel = jlm.GPT(jcfg)
    params = cached_init(jmodel, 0, jnp.zeros((1, T), jnp.int32),
                         deterministic=True)["params"]
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=1, devices=jax.devices()[:1]))
    tcfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tcfg), config=ds, device="cpu",
        model_parameters=gpt_state_dict_from_jax(jax.device_get(params), tcfg))
    assert teng.module.config.sparse_attention.kernel_impl == kernel
    rng = np.random.RandomState(1)
    jl, tl = [], []
    for _ in range(3):
        ids = rng.randint(0, SMALL["vocab_size"], size=(2, T)).astype(np.int32)
        batch = {"input_ids": ids, "labels": ids}
        jl.append(float(jeng.train_batch(iter([batch]))))
        tl.append(float(teng.train_batch(iter([batch]))))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               jeng.get_global_grad_norm(), rtol=1e-5)
    want = gpt_state_dict_from_jax(jax.device_get(jeng.params), tcfg)
    got = teng.module.state_dict()
    C = SMALL["n_embd"]
    for name, w in want.items():
        g = got[name].float()
        if name.endswith("attn.c_attn.bias"):
            torch.testing.assert_close(g[C:2 * C], w[C:2 * C], rtol=0,
                                       atol=3 * 2 * LR, msg=name)
            g, w = torch.cat([g[:C], g[2 * C:]]), torch.cat([w[:C], w[2 * C:]])
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5, msg=name)
