"""The port's GPT against the JAX package's, on the same weights.

The flax model is initialised by jax, its parameter tree is carried over by
``gpt_state_dict_from_jax``, and both models see the same numpy token ids.
In f32 the two differ only in the order of sums (atol 1e-4 on logits of
order 1). On the flash path (T = 128) the JAX side runs the Pallas kernel in
interpret mode and the port its plain PyTorch version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax

torch.set_num_threads(2)

ATOL = 1e-4
SMALL = dict(vocab_size=128, n_positions=256, n_embd=64, n_layer=2, n_head=2)


def _pair(scan_layers=True, flash=False, bf16=False, seed=0):
    """(jax model, jax params, port model) on one set of weights."""
    jcfg = jlm.GPTConfig(**SMALL, scan_layers=scan_layers,
                         use_flash_attention=flash,
                         dtype=jnp.bfloat16 if bf16 else jnp.float32)
    jmodel = jlm.GPT(jcfg)
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(seed), ids,
                         deterministic=True)["params"]
    tcfg = tlm.GPTConfig(**SMALL, scan_layers=scan_layers,
                         use_flash_attention=flash,
                         dtype=torch.bfloat16 if bf16 else torch.float32)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(
        gpt_state_dict_from_jax(jax.device_get(params), tcfg), assign=True)
    return jmodel, params, tmodel.eval()


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, SMALL["vocab_size"],
                                               size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("flash,t", [(False, 128), (True, 128), (True, 96)])
def test_logits_match_jax(scan_layers, flash, t):
    jmodel, params, tmodel = _pair(scan_layers=scan_layers, flash=flash)
    ids = _ids(2, t)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   deterministic=True))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_bridge_covers_every_parameter():
    _, params, tmodel = _pair(scan_layers=True)
    sd = gpt_state_dict_from_jax(jax.device_get(params), tmodel.config)
    assert set(sd) == set(tmodel.state_dict())
    n_jax = sum(x.size for x in jax.tree.leaves(params))
    assert sum(v.numel() for v in sd.values()) == n_jax
    assert tlm.num_params(tmodel.config) == n_jax


@pytest.mark.parametrize("name", ["gpt2-125m", "gpt2-1.3b", "gpt2-2.7b"])
def test_num_params_matches_jax(name):
    assert tlm.num_params(tlm.gpt2_config(name)) == \
        jlm.num_params(jlm.gpt2_config(name))


@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_match_jax(ragged):
    """Prefill 6 tokens into the KV cache, then decode 4 one by one
    (tests/unit/test_inference.py:22-48); with ``ragged`` the prefill is
    left-padded and masked, which drives the position counter."""
    jmodel, params, tmodel = _pair(scan_layers=True)
    ids = _ids(2, 10, seed=1)
    mask = np.ones((2, 6), bool)
    if ragged:
        mask[0, :2] = False
    jpre, jcache = jmodel.apply(
        {"params": params}, jnp.asarray(ids[:, :6]),
        attention_mask=jnp.asarray(mask), deterministic=True, decode=True,
        mutable=["cache"])
    jcache = jcache["cache"]
    with torch.no_grad():
        tpre, cache = tmodel(torch.from_numpy(ids[:, :6]).long(),
                             torch.from_numpy(mask), decode=True)
    # pad rows attend to nothing real in either model; compare real tokens
    np.testing.assert_allclose(tpre.numpy()[mask], np.asarray(jpre)[mask],
                               atol=ATOL, rtol=0)
    for t in range(6, 10):
        jstep, jcache = jmodel.apply(
            {"params": params, "cache": jcache}, jnp.asarray(ids[:, t:t + 1]),
            deterministic=True, decode=True, mutable=["cache"])
        jcache = jcache["cache"]
        with torch.no_grad():
            tstep, cache = tmodel(torch.from_numpy(ids[:, t:t + 1]).long(),
                                  decode=True, cache=cache)
        np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep),
                                   atol=ATOL, rtol=0, err_msg=f"position {t}")
    assert cache.index.tolist() == [10, 10] and cache.length == 10
    assert cache.position.tolist() == ([8, 10] if ragged else [10, 10])


def test_decode_past_the_cache_raises():
    _, _, tmodel = _pair()
    ids = torch.from_numpy(_ids(1, SMALL["n_positions"])).long()
    with torch.no_grad():
        _, cache = tmodel(ids, decode=True)
        with pytest.raises(ValueError, match="overflow the KV cache"):
            tmodel(ids[:, :1], decode=True, cache=cache)


@pytest.mark.parametrize("flash", [False, True])
def test_bf16_logits_track_jax(flash):
    """bf16 compute on both sides. The frameworks round to bf16 at different
    points (flax rounds each Dense output and bias add separately, torch once
    per fused addmm), and bf16 keeps ~3 significant digits, so logits of order
    1 are held to a relative L2 error of 2e-2 instead of the f32 atol."""
    jmodel, params, tmodel = _pair(flash=flash, bf16=True)
    ids = _ids(2, 128, seed=2)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   deterministic=True), np.float32)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long()).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, f"relative L2 error {rel:.4f}"


@pytest.mark.parametrize("field,value", [
    ("rotary", True), ("alibi", True), ("n_kv_head", 1), ("norm", "rmsnorm"),
    ("gated_mlp", True), ("moe_num_experts", 2), ("attention_chunk", 64),
    ("sequence_parallel", "ring"), ("quantized_weights", True),
    ("kv_cache_dtype", "int8"), ("param_offload", True), ("remat", True),
    ("sparse_attention", object()), ("use_flash_attention", "auto"),
])
def test_unported_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError):
        tlm.GPTConfig(**{field: value})


def test_config_fields_mirror_jax():
    jfields = {f.name: f.default for f in dataclasses.fields(jlm.GPTConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(tlm.GPTConfig)}
    assert list(tfields) == list(jfields)
    for name, default in jfields.items():
        if name not in ("dtype", "param_dtype"):
            assert tfields[name] == default, name
