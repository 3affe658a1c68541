"""int8 weights and the int8 KV cache: the port against the JAX package.

Mirrors ``tests/unit/test_inference.py:174-290`` (int8 storage, quality,
generation, the warn-once) and :565 (int8 with the ring cache), and
``tests/unit/test_serving_disagg.py:80-160, 273-360`` (the blockwise
quantizer, the KV dtype validation, resident bytes, every-position logits
of the int8 KV cache). The JAX engines draw the weights (f32 compute on the
CPU); ``gpt_state_dict_from_jax`` carries them across, the quantized tree
included. The int8 products are the same f32 arithmetic in both packages,
so logits agree to the order of sums (atol 1e-4, as the f32 parity tests)
and greedy tokens are identical.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.engine import prefill_chunk_spans
from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.ops.sparse_attention.sparse_attention_utils import \
    apply_sparse_attention as jax_sparse
from deepspeed_tpu_torch.inference import engine as tinf
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.ops import quantizer as tq
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import \
    apply_sparse_attention

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=2)
WINDOW = {"mode": "local_sliding_window", "block": 16,
          "num_sliding_window_blocks": 3}
ATOL = 1e-4


def _tcfg(**kw):
    return tlm.GPTConfig(**{**SMALL, **kw}, dtype=torch.float32)


def _jcfg(**kw):
    return jlm.GPTConfig(**{**SMALL, **kw}, dtype=jnp.float32)


def _ids(shape=(3, 12), seed=0):
    return np.random.RandomState(seed).randint(0, 128, size=shape)


@pytest.fixture(scope="module")
def engines():
    """The JAX int8 engine and its dense twin (fp32, the same seed: the
    same dense weights), their logits, and the port's int8 engine built
    from the dense twin's weights."""
    ids = _ids()
    j8 = deepspeed_tpu.init_inference(jlm.GPT(_jcfg()), dtype="int8")
    j32 = deepspeed_tpu.init_inference(jlm.GPT(_jcfg()), dtype="fp32")
    want8 = np.asarray(j8(jnp.asarray(ids, jnp.int32)))
    want32 = np.asarray(j32(jnp.asarray(ids, jnp.int32)))
    dense = gpt_state_dict_from_jax(jax.device_get(j32.params), _tcfg())
    t8 = deepspeed_tpu_torch.init_inference(
        tlm.GPT(_tcfg()), dtype="int8", device="cpu", state_dict=dense)
    return dict(ids=ids, j8=j8, want8=want8, want32=want32, dense=dense,
                t8=t8)


def test_params_stored_int8_bit_for_bit_with_jax(engines):
    """Exactly JAX's quantized leaves are int8 (every block Dense kernel),
    and the port's quantization of the carried dense twin is the JAX int8
    engine's ``{q, scale}``, carried across, bit for bit."""
    carried = gpt_state_dict_from_jax(jax.device_get(engines["j8"].params),
                                      _tcfg())
    own = engines["t8"].params
    q_keys = sorted(k for k in carried if k.endswith("weight_q"))
    assert len(q_keys) == 2 * 4   # c_attn, attn c_proj, c_fc, mlp c_proj
    assert sorted(k for k in own if k.endswith("weight_q")) == q_keys
    for k in q_keys:
        scale = k[:-1] + "scale"
        assert own[k].dtype == torch.int8 and own[scale].dtype == torch.float32
        assert torch.equal(own[k], carried[k]), k
        assert torch.equal(own[scale], carried[scale]), scale
    # no dense block kernel beside the int8 ones; the embeddings, norms and
    # biases stay floating
    assert not any(k.startswith("h.") and k.endswith(".weight")
                   and ("attn" in k or "mlp" in k) for k in own)
    assert own["wte.weight"].dtype == torch.float32


def test_int8_logits_match_jax_and_stay_near_fp32(engines):
    got = engines["t8"](engines["ids"]).numpy()
    np.testing.assert_allclose(got, engines["want8"], atol=ATOL, rtol=0)
    # the JAX test's quality bound against the dense model
    ref = engines["want32"]
    mse = float(np.mean((got - ref) ** 2))
    assert 0.0 < mse < 0.01 * float(np.var(ref))


@pytest.mark.parametrize("scanned", [True, False], ids=["scanned",
                                                        "unscanned"])
def test_quantized_jax_tree_carries_across(engines, scanned):
    """``gpt_state_dict_from_jax`` takes JAX's quantized tree, scanned
    (``h/block``, q ``[L, in, out]``) and unscanned (``h_i``), and the port
    serves it with JAX's logits."""
    if scanned:
        eng, want = engines["j8"], engines["want8"]
    else:
        eng = deepspeed_tpu.init_inference(
            jlm.GPT(_jcfg(scan_layers=False)), dtype="int8")
        want = np.asarray(eng(jnp.asarray(engines["ids"], jnp.int32)))
    params = jax.device_get(eng.params)
    assert ("h" in params) == scanned
    sd = gpt_state_dict_from_jax(params, _tcfg())
    port = deepspeed_tpu_torch.init_inference(
        tlm.GPT(_tcfg()), dtype="int8", device="cpu", state_dict=sd)
    np.testing.assert_allclose(port(engines["ids"]).numpy(), want,
                               atol=ATOL, rtol=0)


def test_int8_generation_matches_jax(engines):
    ids = engines["ids"]
    want = np.asarray(engines["j8"].generate(jnp.asarray(ids, jnp.int32),
                                             max_new_tokens=6))
    got = engines["t8"].generate(ids, max_new_tokens=6)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_init_quantizes_the_dense_twins_draw():
    """Without weights the int8 engine draws what the dense engine of the
    same seed draws, one layer at a time, and quantizes it."""
    dense = deepspeed_tpu_torch.init_inference(
        tlm.GPT(_tcfg()), dtype="fp32", device="cpu", seed=3).params
    int8 = deepspeed_tpu_torch.init_inference(
        tlm.GPT(_tcfg()), dtype="int8", device="cpu", seed=3).params
    quantized = tlm.quantize_state_dict(
        tlm.GPT(_tcfg(quantized_weights=True)), dense)
    assert quantized.keys() == int8.keys()
    for k, v in quantized.items():
        assert torch.equal(v, int8[k]), k


def test_moe_gate_is_quantized_experts_stay_dense():
    """Under a mixture of experts JAX quantizes the gate's kernel (a Dense
    under the block) and not the experts' stacks (``wi``/``wo`` are not
    ``kernel`` leaves); the logits agree."""
    moe = dict(moe_num_experts=4, moe_top_k=2)
    jeng = deepspeed_tpu.init_inference(jlm.GPT(_jcfg(**moe)), dtype="int8")
    ids = _ids((2, 8), seed=4)
    want = np.asarray(jeng(jnp.asarray(ids, jnp.int32)))
    sd = gpt_state_dict_from_jax(jax.device_get(jeng.params),
                                 _tcfg(**moe))
    assert "h.0.mlp.gate.weight_q" in sd and "h.0.mlp.experts.wi" in sd
    port = deepspeed_tpu_torch.init_inference(
        tlm.GPT(_tcfg(**moe)), dtype="int8", device="cpu", state_dict=sd)
    assert port.params["h.0.mlp.experts.wi"].dtype == torch.float32
    np.testing.assert_allclose(port(ids).numpy(), want, atol=ATOL, rtol=0)


def test_small_model_int8_warns_once(monkeypatch):
    warned = []
    monkeypatch.setattr(tinf, "warning_once", warned.append)
    deepspeed_tpu_torch.init_inference(tlm.GPT(_tcfg()), dtype="int8",
                                       device="cpu")
    deepspeed_tpu_torch.init_inference(tlm.GPT(_tcfg()), dtype="fp32",
                                       device="cpu")
    assert len(warned) == 1 and "dtype=int8" in warned[0]


# -- the int8 KV cache ---------------------------------------------------
@pytest.mark.parametrize("case", ["round_trip", "zeros", "divides"])
def test_blockwise_quantizer_matches_jax(case):
    """The KV cache's format (``quantize_blockwise`` over D): the JAX
    codes and scales bit for bit, the round-trip error within 1/127 of
    each block's max, zeros exact, and a block that does not divide the
    axis refused."""
    if case == "divides":
        with pytest.raises(AssertionError):
            tq.quantize_blockwise(torch.zeros(2, 10), 16)
        return
    x = (np.zeros((2, 16), np.float32) if case == "zeros" else
         np.random.RandomState(0).randn(4, 64).astype(np.float32))
    block = 16 if case == "zeros" else 32
    q, s = tq.quantize_blockwise(torch.from_numpy(x), block)
    jqv, js = jq.quantize_blockwise(jnp.asarray(x), block)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tq.dequantize_blockwise(q, s, torch.float32).numpy()
    if case == "zeros":
        assert back.sum() == 0.0
        return
    bound = np.abs(x).reshape(4, 2, 32).max(-1) / 127.0
    assert (np.abs(back - x).reshape(4, 2, 32)
            <= bound[..., None] + 1e-7).all()


@pytest.mark.parametrize("ring", [False, True], ids=["dense", "ring"])
def test_int8_kv_every_position_matches_jax(ring):
    """A prompt through the int8 KV cache, chunked past the ring (spans of
    one block) or in one pass (dense), then 4 decode steps: every
    position's logits are JAX's, and within the int8 envelope of the
    compute-dtype cache's (argmax flips only at near-ties).

    Tolerance: a key or value that is one f32 ulp away in the two packages
    (the rotary products' order) and sits at a rounding tie takes the
    neighbouring int8 code, one step of its row's max|x| / 127, which moves
    a logit by up to ~1e-3 here; so 5e-3 (the compute-dtype caches agree
    to 1e-4), and the greedy tokens must agree."""
    fields = dict(n_positions=128)
    if ring:
        fields.update(rotary=True, learned_positions=False)

    def models(**kv):
        jm = jlm.GPT(_jcfg(**fields, **kv))
        tm = tlm.GPT(_tcfg(**fields, **kv))
        if ring:
            jm, tm = jax_sparse(jm, WINDOW), apply_sparse_attention(tm,
                                                                    WINDOW)
        return jm, tm

    T, steps = 64, 4
    ids = _ids((2, T), seed=3)
    jm8, tm8 = models(kv_cache_dtype="int8")
    params = cached_init(jm8, 0, jnp.asarray(ids, jnp.int32),
                      deterministic=True)["params"]
    spans = prefill_chunk_spans(jm8.config, T) or [(0, T)]
    assert (len(spans) > 2) == ring

    @jax.jit
    def first(x):
        return jm8.apply({"params": params}, x, deterministic=True,
                         decode=True, mutable=["cache"])

    @jax.jit
    def more(cache, x):
        return jm8.apply({"params": params, "cache": cache}, x,
                         deterministic=True, decode=True, mutable=["cache"])

    want = []
    cache = None
    for s, e in spans:
        x = jnp.asarray(ids[:, s:e], jnp.int32)
        logits, out = first(x) if cache is None else more(cache, x)
        cache = out["cache"]
        want.append(np.asarray(logits))
    for _ in range(steps):
        tok = want[-1][:, -1].argmax(-1)
        logits, out = more(cache, jnp.asarray(tok[:, None], jnp.int32))
        cache = out["cache"]
        want.append(np.asarray(logits))
    want = np.concatenate(want, axis=1)

    sd = gpt_state_dict_from_jax(jax.device_get(params), tm8.config)

    def port_logits(tm):
        tlm.materialize_gpt(tm, "cpu", torch.Generator(), state_dict=sd)
        tm.eval()
        cache = tlm.kv_cache(tm.config, 2, "cpu")
        got = []
        with torch.no_grad():
            for s, e in spans:
                got.append(tm(torch.from_numpy(ids[:, s:e]), decode=True,
                              cache=cache)[0])
            for _ in range(steps):
                tok = got[-1][:, -1].argmax(-1)
                got.append(tm(tok[:, None], decode=True, cache=cache)[0])
        return torch.cat(got, dim=1).numpy(), cache

    got, cache8 = port_logits(tm8)
    assert cache8.key[0].dtype == torch.int8
    assert cache8.key_scale[0].shape == cache8.key[0].shape[:3]
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    np.testing.assert_array_equal(got[:, T - 1:].argmax(-1),
                                  want[:, T - 1:].argmax(-1))
    ref, _ = port_logits(models()[1])
    err = np.abs(ref - got).max()
    assert err < 0.05 * np.abs(ref).max()
    top2 = np.sort(ref, axis=-1)
    margin = top2[..., -1] - top2[..., -2]
    flips = ref.argmax(-1) != got.argmax(-1)
    assert margin[flips].max(initial=0.0) < 2.0 * err


def test_int8_weights_compose_with_the_ring_cache():
    """int8 weights and the ring cache in one model (JAX
    test_inference.py:565): the JAX int8 ring engine's greedy tokens."""
    cfg = dict(n_positions=128)
    jeng = deepspeed_tpu.init_inference(
        jax_sparse(jlm.GPT(_jcfg(**cfg)), WINDOW), dtype="int8")
    ids = _ids((1, 48), seed=14)
    want = np.asarray(jeng.generate(jnp.asarray(ids, jnp.int32),
                                    max_new_tokens=9))
    tm = apply_sparse_attention(tlm.GPT(_tcfg(**cfg)), WINDOW)
    sd = gpt_state_dict_from_jax(jax.device_get(jeng.params), tm.config)
    port = deepspeed_tpu_torch.init_inference(tm, dtype="int8", device="cpu",
                                              state_dict=sd)
    got = port.generate(ids, max_new_tokens=9)
    assert isinstance(port._decoder(1).cache, tlm.RingKVCache)
    assert port._decoder(1).cache.key[0].shape[1] == 32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_kv_composes_with_int8_weights():
    """Both int8 options at once: the JAX engine's tokens."""
    config = {"kv_cache": "int8"}
    jeng = deepspeed_tpu.init_inference(jlm.GPT(_jcfg()), dtype="int8",
                                        config=dict(config))
    ids = _ids((2, 10), seed=5)
    want = np.asarray(jeng.generate(jnp.asarray(ids, jnp.int32),
                                    max_new_tokens=9))
    sd = gpt_state_dict_from_jax(jax.device_get(jeng.params), _tcfg())
    port = deepspeed_tpu_torch.init_inference(
        tlm.GPT(_tcfg()), dtype="int8", config=dict(config), device="cpu",
        state_dict=sd)
    cfg = port.module.config
    assert cfg.quantized_weights and cfg.kv_cache_dtype == "int8"
    np.testing.assert_array_equal(
        port.generate(ids, max_new_tokens=9).numpy(), want)


@pytest.mark.parametrize("slack", [0, 1])
def test_ring_resident_bytes_int8_against_compute(slack):
    """The ring's bytes: int8 keys and values with f32 scales per (slot,
    head) against the compute dtype's; slack blocks grow the storage, not
    the visibility."""
    def cache(**kv):
        tm = apply_sparse_attention(
            tlm.GPT(_tcfg(n_positions=128, kv_cache_slack_blocks=slack,
                          **kv)), WINDOW)
        return tlm.kv_cache(tm.config, 2, "cpu")

    full, int8 = cache(), cache(kv_cache_dtype="int8")
    assert full.key[0].shape[1] == 32 + 16 * slack
    D = SMALL["n_embd"] // SMALL["n_head"]
    kv_full = sum(t.numel() * 4 for t in full.key + full.value)
    kv_int8 = sum(t.numel() * t.element_size()
                  for t in int8.key + int8.value + int8.key_scale
                  + int8.value_scale)
    assert kv_full / kv_int8 == pytest.approx(4 * D / (D + 4))
    assert full.nbytes() - kv_full == int8.nbytes() - kv_int8


def test_unquantized_config_builds_dense_blocks():
    """``quantized_weights`` swaps every block Dense for a QuantizedDense
    and nothing else."""
    model = tlm.GPT(_tcfg(quantized_weights=True))
    kinds = {type(m).__name__ for m in model.h.modules()}
    assert "QuantizedDense" in kinds and "Dense" not in kinds
    plain = tlm.GPT(dataclasses.replace(model.config,
                                        quantized_weights=False))
    assert "QuantizedDense" not in {type(m).__name__ for m in plain.modules()}
