"""Speculative decoding in the port's scheduler against the JAX package's.

Mirrors ``tests/unit/test_serving_disagg.py:126-160`` (the preconditions)
and :383-470 (an independent draft exact, a self-draft accepting k-1 of k
per step, a dense target and draft, EOS inside an accepted run, the int8
KV cache with speculation). Every emitted token is a target argmax given
the emitted prefix, so the stream equals the scheduler's without a draft;
the targets' weights come from the JAX engines (f32 on the CPU) and the
tokens must be the JAX scheduler's. The stream does not depend on a
draft's weights: an independent draft takes the port's own seeded draw, a
self-draft the target's weights.
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
from deepspeed_tpu_torch.inference.scheduler import \
    ContinuousBatchingScheduler
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import \
    apply_sparse_attention

torch.set_num_threads(2)

WINDOW = {"mode": "local_sliding_window", "block": 16,
          "num_sliding_window_blocks": 3}
BASE = dict(vocab_size=128, n_positions=256, n_embd=64, n_layer=2, n_head=4)
RING_FIELDS = dict(rotary=True, learned_positions=False)
NEW = 8


def _prompts(seed=0, lengths=(7, 23, 40, 70, 12)):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 128, size=n)] for n in lengths]


def _engines(ring, seed, kv=None, **fields):
    """A JAX engine (``seed``'s weights) and the port's on its weights."""
    if ring:
        fields = {**RING_FIELDS, **fields}
    jm = jlm.GPT(jlm.GPTConfig(**BASE, dtype=jnp.float32, **fields))
    if ring:
        jm = jax_sparse(jm, WINDOW)
    config = {"dtype": "fp32"}
    if kv is not None:
        config["kv_cache"] = kv
    jeng = JaxEngine(jm, dict(config), seed=seed)
    # the weights alone (its init at a length the window's layout takes)
    jeng._materialize(jnp.zeros((1, 48), jnp.int32))
    sd = gpt_state_dict_from_jax(jax.device_get(jeng.params),
                                 _port_model(ring, **fields).config)
    return jeng, _port(ring, sd, kv, **fields)


def _port_model(ring, **fields):
    tm = tlm.GPT(tlm.GPTConfig(**BASE, dtype=torch.float32, **fields))
    return apply_sparse_attention(tm, WINDOW) if ring else tm


def _port(ring, sd=None, kv=None, seed=0, **fields):
    """The port's engine on the weights ``sd``, or on its own draw from
    ``seed``."""
    config = {"dtype": "fp32"}
    if kv is not None:
        config["kv_cache"] = kv
    return deepspeed_tpu_torch.init_inference(
        _port_model(ring, **fields), config=config, device="cpu",
        state_dict=sd, seed=seed)


def _run(sched, prompts, new=NEW, **kw):
    for p in prompts:
        sched.submit(p, max_new_tokens=new, **kw)
    stats = sched.run()
    got = {c.request_id: c.tokens for c in stats.completions}
    return stats, [got[i] for i in range(len(prompts))]


@pytest.fixture(scope="module")
def ring():
    """The ring target (one slack block), an independent draft (seed 7), a
    self-draft (the target's weights, slack-free), and the JAX scheduler's
    tokens (its stream with a draft is its stream without one: every
    emitted token is a target argmax)."""
    jt, target = _engines(True, 0, kv_cache_slack_blocks=1)
    draft = _port(True, seed=7, **RING_FIELDS)
    # the target's weights (a slack block changes no parameter)
    self_draft = _port(True, {k: v.clone() for k, v in
                              target.module.state_dict().items()},
                       **RING_FIELDS)
    prompts = _prompts()
    _, base = _run(JaxScheduler(jt, slots=3), prompts)
    return dict(target=target, draft=draft, self_draft=self_draft,
                prompts=prompts, base=base)


def test_independent_draft_is_exact(ring):
    sched = ContinuousBatchingScheduler(ring["target"], slots=3,
                                        draft_engine=ring["draft"], spec_k=4)
    stats, got = _run(sched, ring["prompts"])
    assert got == ring["base"]
    assert sched.spec_proposed > 0
    spec = sched.frontdoor_stats()["spec"]
    assert spec["k"] == 4 and spec["proposed"] == sched.spec_proposed
    assert spec["accepted"] == sched.spec_accepted


def test_self_draft_accepts_k_minus_1_of_k(ring):
    """Draft == target weights: every proposal matches, so each step
    accepts k-1 drafts plus the verified token, and the steps fall ~k-fold
    against decoding without a draft."""
    _, plain_toks = _run(ContinuousBatchingScheduler(ring["target"],
                                                     slots=3),
                         ring["prompts"])
    plain = ContinuousBatchingScheduler(ring["target"], slots=3)
    st0, _ = _run(plain, ring["prompts"])
    sched = ContinuousBatchingScheduler(ring["target"], slots=3,
                                        draft_engine=ring["self_draft"],
                                        spec_k=4)
    st, got = _run(sched, ring["prompts"])
    assert got == plain_toks == ring["base"]
    assert sched.spec_accepted == sched.spec_proposed * 3 // 4
    assert st.decode_steps < st0.decode_steps


def test_eos_truncates_inside_an_accepted_run(ring):
    """An EOS emitted mid-acceptance stops that lane where sequential decode
    would, not at the end of the accepted run."""
    prompts = ring["prompts"][:2]
    base = ring["base"][:2]
    eos = base[0][2]

    def trunc(seq):
        return seq[:seq.index(eos) + 1] if eos in seq else seq

    assert len(trunc(base[0])) < NEW
    sched = ContinuousBatchingScheduler(ring["target"], slots=2,
                                        draft_engine=ring["self_draft"],
                                        spec_k=4)
    _, got = _run(sched, prompts, eos_token_id=eos)
    assert got == [trunc(b) for b in base]


def test_int8_kv_composes_with_spec(ring):
    """The int8 KV target with speculation: the JAX int8 KV scheduler's
    tokens (its stream, with or without a draft, is its sequential
    greedy's)."""
    jt, target = _engines(True, 0, kv="int8", kv_cache_slack_blocks=1)
    _, want = _run(JaxScheduler(jt, slots=3), ring["prompts"])
    sched = ContinuousBatchingScheduler(target, slots=3,
                                        draft_engine=ring["self_draft"],
                                        spec_k=4)
    _, got = _run(sched, ring["prompts"])
    assert got == want


def test_dense_target_and_draft():
    prompts = _prompts(seed=1)
    jt, target = _engines(False, 0)
    draft = _port(False, seed=7)
    _, base = _run(JaxScheduler(jt, slots=3, prompt_bucket=16), prompts)
    sched = ContinuousBatchingScheduler(target, slots=3, prompt_bucket=16,
                                        draft_engine=draft, spec_k=3)
    _, got = _run(sched, prompts)
    assert got == base


def test_rewind_restores_exactly_the_rejected_writes(ring):
    """``KVCache.rewind`` after a 4-column pass with per-row rejections
    (2, 0, 4): each row is the cache of a pass of its accepted columns
    only (buffers, valid, slot positions, clocks)."""
    model = ring["target"].module
    cfg = model.config
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 128, (3, 20)))
    with torch.inference_mode():
        live = tlm.kv_cache(cfg, 3, "cpu")
        model(ids[:, :16], decode=True, cache=live)
        snap = live.clone()
        model(ids[:, 16:], decode=True, cache=live)
        live.rewind(snap, np.array([2, 0, 4]))
        for row, keep in enumerate((2, 4, 0)):
            want = tlm.kv_cache(cfg, 1, "cpu")
            model(ids[row:row + 1, :16 + keep], decode=True, cache=want)
            got = [t[row:row + 1] for t in live.tensors()]
            for g, w in zip(got, want.tensors(), strict=True):
                assert torch.equal(g, w)
            assert live.lengths[row] == want.lengths[0] == 16 + keep


@pytest.mark.parametrize("case", ["k_without_draft", "draft_without_k",
                                  "temperature", "ring_slack",
                                  "k_past_block", "same_engine",
                                  "negative_k"])
def test_spec_preconditions(ring, case):
    """JAX's preconditions (scheduler.py :267-313), raised at construction
    with JAX's messages; and the port's own: the draft must be another
    engine (the two would share the engine's caches)."""
    target, draft = ring["target"], ring["draft"]
    kw = {"draft_engine": draft, "spec_k": 4}
    match = None
    if case == "k_without_draft":
        kw = {"spec_k": 4}
        match = "draft_engine"
    elif case == "draft_without_k":
        kw = {"draft_engine": draft}
        match = "spec_k"
    elif case == "temperature":
        kw["temperature"] = 0.7
        match = "temperature"
    elif case == "ring_slack":
        target = ring["self_draft"]   # no slack block
        match = "slack"
    elif case == "k_past_block":
        kw["spec_k"] = 17
        match = "spec_k"
    elif case == "same_engine":
        kw["draft_engine"] = target
        match = "another engine"
    else:
        kw["spec_k"] = -1
        match = "spec_k"
    with pytest.raises(ValueError, match=match):
        ContinuousBatchingScheduler(target, **kw)
