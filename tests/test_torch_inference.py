"""The port's InferenceEngine against the JAX package's, on the same weights.

The JAX engine draws the weights; ``gpt_state_dict_from_jax`` carries them to
the port's engine on the CPU. Both serve in f32, so logits agree to the order
of sums (atol 1e-4) and greedy decoding must give the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu_torch.inference import engine as tinf
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=2)


def _port_engine(params=None, **kw):
    cfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    sd = None if params is None else gpt_state_dict_from_jax(params, cfg)
    return deepspeed_tpu_torch.init_inference(
        tlm.GPT(cfg), dtype="fp32", device="cpu", state_dict=sd, **kw)


@pytest.fixture(scope="module")
def engines():
    jeng = deepspeed_tpu.init_inference(
        jlm.GPT(jlm.GPTConfig(**SMALL, dtype=jnp.float32)), dtype="fp32")
    ids = np.random.RandomState(0).randint(0, 128, size=(3, 12))
    jlogits = np.asarray(jeng(jnp.asarray(ids, jnp.int32)))
    teng = _port_engine(jax.device_get(jeng.params))
    return jeng, teng, ids, jlogits


def test_forward_matches_jax(engines):
    _, teng, ids, jlogits = engines
    got = teng(ids)
    assert got.shape == (3, 12, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jlogits, atol=1e-4, rtol=0)


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_is_token_identical(engines, ragged):
    jeng, teng, ids, _ = engines
    mask = None
    if ragged:
        # right-padded prompts of lengths 12, 7 and 3; both engines
        # left-align them before prefill
        mask = np.arange(12)[None, :] < np.array([12, 7, 3])[:, None]
    want = np.asarray(jeng.generate(
        jnp.asarray(ids, jnp.int32), max_new_tokens=5,
        attention_mask=None if mask is None else jnp.asarray(mask)))
    got = teng.generate(ids, max_new_tokens=5,
                        attention_mask=None if mask is None
                        else torch.from_numpy(mask))
    assert got.shape == (3, 5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["negative", "empty_row", "too_long",
                                  "mask_shape"])
def test_generate_errors_match_jax(engines, case):
    jeng, teng, ids, _ = engines
    kw = {"max_new_tokens": 4}
    if case == "negative":
        kw["max_new_tokens"] = -1
    elif case == "empty_row":
        mask = np.ones(ids.shape, bool)
        mask[1] = False
        kw["attention_mask"] = mask
    elif case == "too_long":
        kw["max_new_tokens"] = SMALL["n_positions"]
    else:
        kw["attention_mask"] = np.ones((3, 5), bool)
    with pytest.raises(ValueError) as jerr:
        jeng.generate(jnp.asarray(ids, jnp.int32), **kw)
    with pytest.raises(ValueError) as terr:
        teng.generate(ids, **kw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("chunk,runs", [(8, [8, 4]), (6, [4, 4, 4])])
def test_decode_chunk_matches_jax_and_chunk_1(engines, monkeypatch, chunk,
                                              runs):
    """``decode_chunk`` as in the JAX engine: each run is the largest power
    of two <= min(chunk, remaining), and a chunk that is not a power of two
    warns once and runs as the power below it. 13 new tokens (one from
    prefill, then the runs) are the JAX engine's tokens with the same
    config, and the port's with chunk 1 (one step per run)."""
    jeng, _, ids, _ = engines
    jchunk = deepspeed_tpu.init_inference(
        jlm.GPT(jlm.GPTConfig(**SMALL, dtype=jnp.float32)), dtype="fp32",
        config={"decode_chunk": chunk})
    want = np.asarray(jchunk.generate(jnp.asarray(ids, jnp.int32),
                                      max_new_tokens=13))
    params = jax.device_get(jchunk.params)
    seen, warned = [], []
    real_run = tinf.InferenceEngine._decode_run

    def spy(self, decode, cache, tok, k, *args):
        seen.append(k)
        return real_run(self, decode, cache, tok, k, *args)

    monkeypatch.setattr(tinf.InferenceEngine, "_decode_run", spy)
    monkeypatch.setattr(tinf, "warning_once", warned.append)
    teng = _port_engine(params, config={"decode_chunk": chunk})
    got = teng.generate(ids, max_new_tokens=13)
    assert seen == runs
    assert len(warned) == (chunk == 6)
    assert all("decode_chunk=6" in w and "4-token runs" in w for w in warned)
    np.testing.assert_array_equal(got.numpy(), want)
    seen.clear()
    one = _port_engine(params, config={"decode_chunk": 1}).generate(
        ids, max_new_tokens=13)
    assert seen == [1] * 12
    assert torch.equal(one, got)


def test_decode_chunk_defaults_to_32_and_reuses_the_cache(engines):
    """The default chunk is the JAX engine's 32; a second generate on the
    same batch size reuses (and resets) the engine's KV cache and gives the
    same tokens."""
    _, teng, ids, _ = engines
    assert teng.decode_chunk == 32
    first = teng.generate(ids, max_new_tokens=7)
    cache, _ = teng._decoders[ids.shape[0]]
    second = teng.generate(ids, max_new_tokens=7)
    assert teng._decoders[ids.shape[0]][0] is cache
    assert torch.equal(first, second)


def test_zero_new_tokens(engines):
    _, teng, ids, _ = engines
    assert teng.generate(ids, max_new_tokens=0).shape == (3, 0)


def test_sampling_follows_the_seed():
    ids = np.random.RandomState(1).randint(0, 128, size=(2, 6))
    a, b = _port_engine(seed=5), _port_engine(seed=5)
    ta = a.generate(ids, max_new_tokens=6, temperature=0.8)
    tb = b.generate(ids, max_new_tokens=6, temperature=0.8)
    assert torch.equal(ta, tb)
    assert bool(((ta >= 0) & (ta < 128)).all())


def test_random_init_follows_flax_distributions():
    sd = _port_engine(seed=0).params
    assert torch.equal(sd["h.0.ln_1.weight"], torch.ones(64))
    assert not sd["h.0.attn.c_attn.bias"].any()
    w = sd["h.0.mlp.c_fc.weight"]                  # lecun: std 1/sqrt(in)
    assert abs(w.std().item() - 64 ** -0.5) < 0.01
    assert w.abs().max().item() <= 2 * 64 ** -0.5 / 0.8796 + 1e-6
    assert abs(sd["wte.weight"].std().item() - 64 ** -0.5) < 0.01


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(
            tlm.GPT(tlm.GPTConfig(**SMALL)), dtype="fp32")


@pytest.mark.parametrize("kw", [{"mp_size": 2}, {"ep_size": 2},
                                {"dtype": "int8"},
                                {"config": {"kv_cache": "int8"}}])
def test_unported_engine_options_raise(kw):
    kw = {"dtype": "fp32", **kw}
    with pytest.raises(NotImplementedError):
        deepspeed_tpu_torch.init_inference(
            tlm.GPT(tlm.GPTConfig(**SMALL)), device="cpu", **kw)


def test_foreign_models_are_refused():
    with pytest.raises(NotImplementedError, match="not ported"):
        deepspeed_tpu_torch.init_inference(torch.nn.Linear(2, 2),
                                           device="cpu")
