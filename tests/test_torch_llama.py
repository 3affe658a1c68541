"""The port's LLaMA-shaped GPT against the JAX package's, on the same weights.

The config is the one ``llama_from_hf`` (``deepspeed_tpu/module_inject/
hf.py:499``) builds for a LLaMA or Mistral checkpoint: RMSNorm, the gated
SiLU MLP, no biases, full rotary, no position table, grouped-query
attention and an untied head, at a small size (width 256, 4 query heads of
dim 64, 2 layers, vocab 512). The flax model is initialised by jax, its
tree carried over by ``gpt_state_dict_from_jax``, and both models see the
same numpy token ids. In f32 the two differ only in the order of sums:
logits to atol 1e-4 (order 1), the loss and every gradient to 1e-5 of the
gradient's largest entry, as ``test_torch_transformer_lm.py`` holds
GPT-2. On the flash path (T = 128) the JAX side runs the Pallas kernel in
interpret mode and the port its plain PyTorch version.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import (flatten_jax_tree,
                                                           gpt_exchange_layout,
                                                           gpt_state_dict_from_jax)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402
from test_torch_transformer_lm import _packed  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4
GRAD_RTOL = 1e-5
# llama_from_hf's fields (hf.py:516-537) at a small size
LLAMA = dict(vocab_size=512, n_positions=256, n_embd=256, n_layer=2, n_head=4,
             n_kv_head=2, intermediate_size=512, layer_norm_epsilon=1e-5,
             norm="rmsnorm", activation="silu", gated_mlp=True, use_bias=False,
             attn_bias=False, rotary=True, rope_theta=10000.0,
             learned_positions=False, tie_word_embeddings=False, dropout=0.0)
# Mistral-7B-v0.1's config.json through llama_from_hf, n_positions cut to
# its 4096-token sliding window
MISTRAL_7B = dict(LLAMA, vocab_size=32000, n_positions=4096, n_embd=4096,
                  n_layer=32, n_head=32, n_kv_head=8, intermediate_size=14336)


def _pair(flash=False, scan_layers=True, train=False, seed=0, **over):
    """(jax model, jax params, port model) on one set of weights; in
    training mode the port's parameters require grad."""
    fields = dict(LLAMA, **over)
    jmodel = jlm.GPT(jlm.GPTConfig(**fields, scan_layers=scan_layers,
                                   use_flash_attention=flash,
                                   dtype=jnp.float32))
    params = cached_init(jmodel, seed, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    tcfg = tlm.GPTConfig(**fields, scan_layers=scan_layers,
                         use_flash_attention=flash, dtype=torch.float32)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(
        gpt_state_dict_from_jax(jax.device_get(params), tcfg), assign=True)
    if train:
        tmodel.train()
        for prm in tmodel.parameters():
            prm.requires_grad_(True)
    else:
        tmodel.eval()
    return jmodel, params, tmodel


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(
        0, LLAMA["vocab_size"], size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("n_kv_head", [4, 2, 1])
def test_logits_match_jax(n_kv_head, flash, scan_layers):
    jmodel, params, tmodel = _pair(flash=flash, scan_layers=scan_layers,
                                   n_kv_head=n_kv_head)
    ids = _ids(2, 128)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   deterministic=True))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _loss_and_grads(jmodel, params, tmodel, ids, **extra):
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}

    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids),
                            labels=jnp.asarray(ids), deterministic=False,
                            **jextra)

    jl, jg = jax.value_and_grad(jloss)(params)
    tl = tmodel(torch.from_numpy(ids).long(),
                labels=torch.from_numpy(ids).long(),
                **{k: torch.from_numpy(v).long() for k, v in extra.items()})
    tl.backward()
    want = gpt_state_dict_from_jax(jax.device_get(jg), tmodel.config)
    got = {n: prm.grad for n, prm in tmodel.named_parameters()}
    return float(tl.detach()), float(jl), got, want


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= GRAD_RTOL * scale + 1e-9, f"{name}: {err} of {scale}"


# (n_kv_head, flash, scan_layers, extra config fields)
GRAD_CASES = {
    "mha": (4, False, True, {}),
    "mha_flash": (4, True, True, {}),
    "gqa2": (2, False, True, {}),
    "gqa2_flash": (2, True, True, {}),
    "mqa": (1, False, True, {}),
    "mqa_flash": (1, True, True, {}),
    "gqa2_unscanned": (2, False, False, {}),
    "gqa2_flash_unscanned": (2, True, False, {}),
    # Qwen2's mix (hf.py:529): biased attention projections, bias-free MLP
    "attn_bias": (2, True, True, {"attn_bias": True}),
    "lm_head_bias": (2, False, True, {"lm_head_bias": True}),
    "flash_remat": (2, True, True, {"remat": True}),
    "tied_half_rotary_interleaved": (2, False, True, {
        "tie_word_embeddings": True, "rotary_pct": 0.5,
        "rotary_interleaved": True, "rope_theta": 1e6}),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_loss_and_every_gradient_match_jax(case):
    n_kv_head, flash, scan_layers, over = GRAD_CASES[case]
    jmodel, params, tmodel = _pair(flash=flash, scan_layers=scan_layers,
                                   train=True, n_kv_head=n_kv_head, **over)
    tl, jl, got, want = _loss_and_grads(jmodel, params, tmodel,
                                        _ids(2, 128, seed=3))
    assert abs(tl - jl) <= GRAD_RTOL * abs(jl)
    _assert_grads(got, want)


@pytest.mark.parametrize("n_kv_head", [2, 1])
@pytest.mark.parametrize("flash", [False, True])
def test_packed_rotary_matches_jax(flash, n_kv_head):
    """Packed batches under rotary: the per-document positions restart the
    phases, the segment ids keep attention in each document (the port's
    form of tests/unit/test_data_pipeline.py:477-495)."""
    jmodel, params, tmodel = _pair(flash=flash, train=True,
                                   n_kv_head=n_kv_head)
    seg, pos = _packed(2, 128)
    tl, jl, got, want = _loss_and_grads(jmodel, params, tmodel,
                                        _ids(2, 128, seed=4),
                                        segment_ids=seg, positions=pos)
    assert abs(tl - jl) <= GRAD_RTOL * abs(jl)
    _assert_grads(got, want)


def test_packed_document_sees_its_own_phases():
    """A document packed after another gets the logits it has alone."""
    _, _, tmodel = _pair()
    ids = _ids(1, 128, seed=5)
    seg, pos = _packed(2, 128)
    with torch.no_grad():
        packed = tmodel(torch.from_numpy(ids).long(),
                        segment_ids=torch.from_numpy(seg[:1]).long(),
                        positions=torch.from_numpy(pos[:1]).long())
        alone = tmodel(torch.from_numpy(ids[:, 40:90]).long())
    np.testing.assert_allclose(packed[0, 40:90].numpy(), alone[0].numpy(),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("n_kv_head", [2, 1])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_match_jax(ragged, n_kv_head):
    """Prefill 6 tokens into the grouped KV cache, then decode 4 one by
    one; with ``ragged`` the prefill is left-padded and masked, and the
    rotary phases are the cache slots, pads included, on both sides."""
    jmodel, params, tmodel = _pair(n_kv_head=n_kv_head)
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
                             attention_mask=torch.from_numpy(mask),
                             decode=True)
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
    # the cache holds the KV heads, not repeated; no position counter
    assert tuple(cache.key[0].shape) == (2, LLAMA["n_positions"], n_kv_head, 64)
    assert cache.position is None and cache.length == 10
    jkey = np.asarray(jcache["h"]["block"]["attn"]["cached_key"][0])
    np.testing.assert_allclose(cache.key[0].numpy(), jkey, atol=ATOL, rtol=0)


def test_exchange_layout_is_the_jax_flat_layout():
    """``gpt_exchange_layout`` of the LLaMA-shaped GPT lays its parameters
    out as ``jax.tree.flatten`` of the flax tree, scanned and unscanned."""
    for scan_layers in (True, False):
        _, params, tmodel = _pair(scan_layers=scan_layers,
                                  lm_head_bias=True)
        named = list(tmodel.named_parameters())
        layout = gpt_exchange_layout([(n, p.shape) for n, p in named],
                                     tmodel.config)
        leaves = flatten_jax_tree(jax.device_get(params))
        assert [(p, s) for p, s in layout.leaves] == \
            [(p, tuple(a.shape)) for p, a in leaves]
        flat = torch.cat([torch.from_numpy(np.array(a, np.float32)).reshape(-1)
                          for _, a in leaves])
        for i, (name, prm) in enumerate(named):
            np.testing.assert_array_equal(layout.view(flat, i).numpy(),
                                          prm.detach().numpy(), err_msg=name)


@pytest.mark.parametrize("fields", [
    LLAMA, dict(LLAMA, n_kv_head=1), dict(LLAMA, attn_bias=True),
    dict(LLAMA, lm_head_bias=True, tie_word_embeddings=True), MISTRAL_7B,
    dict(MISTRAL_7B, n_layer=8)], ids=["llama", "mqa", "attn_bias",
                                       "tied_head_bias", "mistral_7b",
                                       "mistral_7b_8_layers"])
def test_num_params_matches_jax(fields):
    assert tlm.num_params(tlm.GPTConfig(**fields)) == \
        jlm.num_params(jlm.GPTConfig(**fields))


def test_mistral_7b_parameter_count():
    """N of Mistral-7B-v0.1 (hidden 4096, 32 layers, 8 KV heads,
    intermediate 14336, vocab 32000, untied): 7,241,732,096; the card
    phase's config is this one."""
    import chip_smoke

    assert chip_smoke.MISTRAL_7B == {k: v for k, v in MISTRAL_7B.items()
                                     if k != "dropout"}
    assert tlm.num_params(tlm.GPTConfig(**MISTRAL_7B)) == 7_241_732_096
    model = tlm.GPT(tlm.GPTConfig(**dict(MISTRAL_7B, n_layer=1)))
    per_layer = sum(p.numel() for p in model.h[0].parameters())
    assert per_layer == 218_112_000
    assert tuple(model.lm_head.shape) == (4096, 32000)
    assert model.wpe is None


def test_bridge_covers_every_parameter():
    _, params, tmodel = _pair(lm_head_bias=True)
    sd = gpt_state_dict_from_jax(jax.device_get(params), tmodel.config)
    assert set(sd) == set(tmodel.state_dict())
    n_jax = sum(x.size for x in jax.tree.leaves(params))
    assert sum(v.numel() for v in sd.values()) == n_jax
    assert tlm.num_params(tmodel.config) == n_jax
    assert "lm_head" in sd and "wpe.weight" not in sd
    assert not any(k.endswith(".bias") for k in sd)


def test_materialize_draws_the_jax_distributions():
    """A random init of the LLaMA-shaped GPT: unit RMSNorm scales, no
    biases to fill, the untied head normal(0.02) (JAX :1170-1173)."""
    cfg = tlm.GPTConfig(**dict(LLAMA, vocab_size=4096, lm_head_bias=True))
    model = tlm.GPT(cfg)
    tlm.materialize_gpt(model, "cpu", torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    assert all(bool((m.weight == 1).all()) for m in model.modules()
               if isinstance(m, tlm.RMSNorm))
    assert abs(float(model.lm_head.std()) - 0.02) < 1e-3
    assert abs(float(model.lm_head.mean())) < 1e-3
    assert bool((model.lm_head_bias == 0).all())
    assert isinstance(model.h[0].ln_1, tlm.RMSNorm)
    assert model.h[0].mlp.c_gate.bias is None


@pytest.mark.parametrize("field,value,words", [
    ("norm", "batchnorm", "unknown norm"),
    ("n_kv_head", 5, "divisible by n_kv_head"),
])
def test_config_validation_matches_jax(field, value, words):
    with pytest.raises(ValueError, match=words):
        jlm.GPTConfig(**{field: value})
    with pytest.raises(ValueError, match=words):
        tlm.GPTConfig(**{field: value})


def test_config_properties_match_jax():
    for fields in (LLAMA, dict(LLAMA, rotary_pct=0.25, n_kv_head=None),
                   dict(LLAMA, n_head=8, rotary_pct=0.3)):
        j, t = jlm.GPTConfig(**fields), tlm.GPTConfig(**fields)
        assert (t.kv_heads, t.rotary_dim, t.head_dim) == \
            (j.kv_heads, j.rotary_dim, j.head_dim)
