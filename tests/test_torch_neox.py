"""The port's GPT-NeoX, GPT-J and BLOOM forms against the JAX package's, on
the same weights: the parallel residual, the embedding LayerNorm and ALiBi.

The configs are the fields ``gptneox_from_hf`` (``deepspeed_tpu/
module_inject/hf.py:266``), ``gptj_from_hf`` (:341) and ``bloom_from_hf``
(:813) set, at a small size (width 128, 4 heads of dim 32, 2 layers, vocab
512). The flax model is initialised by jax, its tree carried over by
``gpt_state_dict_from_jax``, and both models see the same numpy token ids.
In f32 the two differ only in the order of sums: logits to atol 1e-4, the
loss and every gradient to 1e-5 of the gradient's largest entry, as
``test_torch_llama.py`` holds the LLaMA trunk. In bf16 the products round
at different points in the two frameworks, so logits are held to a
relative L2 error of 2e-2 (``test_torch_transformer_lm.py``'s bf16
bound); the ALiBi bias itself, built in the scores' dtype, must equal
JAX's bit for bit. On the flash path the JAX side runs the Pallas kernel
in interpret mode and the port its plain PyTorch version.
"""

import dataclasses
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
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4
GRAD_RTOL = 1e-5
BF16_REL_L2 = 2e-2
BASE = dict(vocab_size=512, n_positions=512, n_embd=128, n_layer=2,
            n_head=4, layer_norm_epsilon=1e-5, dropout=0.0)
# gptneox_from_hf's fields: parallel residual, partial rotary, exact GELU,
# biases, an untied head, no position table
NEOX = dict(BASE, intermediate_size=512, activation="gelu", rotary=True,
            rotary_pct=0.25, rope_theta=10000.0, learned_positions=False,
            tie_word_embeddings=False, parallel_residual=True)
# gptj_from_hf's: parallel residual with one shared LayerNorm (equal ln_1
# and ln_2 weights), interleaved rotary, bias-free attention, biased MLP,
# an untied head with a bias
GPTJ = dict(BASE, activation="gelu_tanh", use_bias=True, attn_bias=False,
            rotary=True, rotary_pct=0.5, rotary_interleaved=True,
            learned_positions=False, tie_word_embeddings=False,
            lm_head_bias=True, parallel_residual=True)
# bloom_from_hf's: ALiBi, the embedding LayerNorm, the tanh GELU, a tied
# head, no position table
BLOOM = dict(BASE, activation="gelu_tanh", alibi=True, embed_layernorm=True,
             learned_positions=False, tie_word_embeddings=True)
FORMS = {"neox": NEOX, "gptj": GPTJ, "bloom": BLOOM,
         "bloom_gqa": dict(BLOOM, n_kv_head=2)}


def _params(fields, seed=0, scan_layers=True):
    jmodel = jlm.GPT(jlm.GPTConfig(**fields, scan_layers=scan_layers,
                                   dtype=jnp.float32))
    params = cached_init(jmodel, seed, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    params = jax.device_get(params)
    if fields is GPTJ:
        # GPT-J's one LayerNorm: ln_2 holds ln_1's weights (hf.py:376)
        block = params["h"]["block"] if scan_layers else None
        layers = [block] if scan_layers else [
            params[f"h_{i}"] for i in range(fields["n_layer"])]
        for lp in layers:
            lp["ln_2"] = {k: np.array(v) for k, v in lp["ln_1"].items()}
    return params


def _pair(fields, flash=False, scan_layers=True, train=False, bf16=False,
          seed=0, **over):
    """(jax model, jax params, port model) on one set of weights; in
    training mode the port's parameters require grad."""
    fields = dict(fields, **over) if over else fields
    params = _params(fields, seed, scan_layers)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jmodel = jlm.GPT(jlm.GPTConfig(**fields, scan_layers=scan_layers,
                                   use_flash_attention=flash, dtype=jdt))
    tcfg = tlm.GPTConfig(**fields, scan_layers=scan_layers,
                         use_flash_attention=flash,
                         dtype=torch.bfloat16 if bf16 else torch.float32)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(gpt_state_dict_from_jax(params, tcfg), assign=True)
    if train:
        tmodel.train()
        for prm in tmodel.parameters():
            prm.requires_grad_(True)
    else:
        tmodel.eval()
    return jmodel, params, tmodel


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(
        0, BASE["vocab_size"], size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_logits_match_jax(form, flash, scan_layers):
    jmodel, params, tmodel = _pair(FORMS[form], flash=flash,
                                   scan_layers=scan_layers)
    ids = _ids(2, 128)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   deterministic=True))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _loss_and_grads(jmodel, params, tmodel, ids):
    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids),
                            labels=jnp.asarray(ids), deterministic=False)

    jl, jg = jax.value_and_grad(jloss)(params)
    tl = tmodel(torch.from_numpy(ids).long(),
                labels=torch.from_numpy(ids).long())
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


# (form, flash, scan_layers, extra config fields)
GRAD_CASES = {
    "neox": ("neox", False, True, {}),
    "neox_flash_remat": ("neox", True, True, {"remat": True}),
    "neox_unscanned": ("neox", False, False, {}),
    "gptj": ("gptj", False, True, {}),
    "gptj_flash": ("gptj", True, False, {}),
    "bloom": ("bloom", False, True, {}),
    "bloom_remat_unscanned": ("bloom", True, False, {"remat": True}),
    "bloom_gqa": ("bloom_gqa", False, True, {}),
    # the embedding LayerNorm on GPT-2's trunk (learned positions)
    "gpt2_ln_embed": ("gpt2", False, True, {}),
}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_loss_and_every_gradient_match_jax(case):
    form, flash, scan_layers, over = GRAD_CASES[case]
    fields = (dict(BASE, embed_layernorm=True) if form == "gpt2"
              else FORMS[form])
    jmodel, params, tmodel = _pair(fields, flash=flash,
                                   scan_layers=scan_layers, train=True, **over)
    tl, jl, got, want = _loss_and_grads(jmodel, params, tmodel,
                                        _ids(2, 128, seed=3))
    assert abs(tl - jl) <= GRAD_RTOL * abs(jl)
    _assert_grads(got, want)


def test_parallel_residual_is_not_the_sequential_block():
    """The same weights through the sequential block give other logits:
    the parallel form is really taken."""
    _, params, tmodel = _pair(NEOX)
    seq = tlm.GPT(dataclasses.replace(tmodel.config, parallel_residual=False))
    seq.load_state_dict(gpt_state_dict_from_jax(params, seq.config),
                        assign=True)
    seq.eval()
    ids = torch.from_numpy(_ids(1, 64)).long()
    with torch.no_grad():
        assert not torch.allclose(tmodel(ids), seq(ids), atol=1e-3)


def test_gptj_shared_layernorm_is_one_norm():
    """GPT-J's single LayerNorm: ln_1 and ln_2 carry the same weights, so
    the block reads one normalised input (the port's ln_2 output equals
    its ln_1 output)."""
    _, _, tmodel = _pair(GPTJ)
    blk = tmodel.h[0]
    x = torch.randn(2, 8, BASE["n_embd"])
    with torch.no_grad():
        assert torch.equal(blk.ln_1(x), blk.ln_2(x))


@pytest.mark.parametrize("n_head", [12, 32, 4, 6, 20])
def test_alibi_slopes_match_jax(n_head):
    """Exact, powers of two or not (12 and 20 take the interleaved extra
    slopes of HF's build_alibi_tensor)."""
    got = tlm.alibi_slopes(n_head)
    want = jlm.alibi_slopes(n_head)
    assert got.dtype == np.float32 and got.shape == (n_head,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_alibi_bias_is_jax_bit_for_bit(dtype):
    """The bias at T = 640 > 256: the positions in the given dtype (bf16
    rounds 257 to 256, 639 to 640, ...), times the f32 slopes, f32 out, as
    JAX's ``slopes * jnp.arange(T, dtype=att.dtype)``. (Both models pass
    f32, their scores' dtype: JAX's numpy-f64 scale promotes bf16 scores,
    which ``test_alibi_logits_past_256_match_jax`` holds.)"""
    n_head, t = 12, 640
    slopes = jnp.asarray(jlm.alibi_slopes(n_head))
    want = np.asarray(slopes[:, None] * jnp.arange(
        t, dtype=getattr(jnp, dtype))[None, :])
    got = tlm.alibi_bias(n_head, t, getattr(torch, dtype), "cpu")
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == "bfloat16":
        assert float(got[0, 257]) == float(got[0, 256])


def _bf16_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("form", ["bloom", "bloom_gqa"])
def test_alibi_logits_past_256_match_jax(form):
    """T = 384 in f32 (atol) and in bf16 (relative L2): in the bf16 model
    the scores are f32 on both sides, so positions past 256 stay exact (bf16
    positions would part from JAX by ~2e-2 here, as much as bf16 parts
    from f32 without ALiBi)."""
    ids = _ids(1, 384, seed=6)
    _, params, tmodel = _pair(FORMS[form])
    jmodel = jlm.GPT(jlm.GPTConfig(**FORMS[form], dtype=jnp.float32))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   deterministic=True))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    jmodel, params, tmodel = _pair(FORMS[form], bf16=True)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   deterministic=True), np.float32)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long()).numpy()
    assert _bf16_rel(got, want) < BF16_REL_L2


@pytest.mark.parametrize("form", ["bloom", "bloom_gqa", "neox"])
@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_and_decode_match_jax(form, ragged):
    """Prefill 6 tokens, then decode 4 one by one; under ALiBi the grouped
    decode biases each cache slot by its absolute position, the KV heads'
    groups taking their query heads' slopes; with ``ragged`` the prefill
    is left-padded and masked."""
    jmodel, params, tmodel = _pair(FORMS[form])
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


def test_alibi_with_segment_ids_raises_like_jax():
    jmodel, params, tmodel = _pair(BLOOM)
    ids = _ids(1, 16)
    seg = np.ones((1, 16), np.int32)
    with pytest.raises(NotImplementedError, match="segment-aware"):
        jmodel.apply({"params": params}, jnp.asarray(ids),
                     segment_ids=jnp.asarray(seg), deterministic=True)
    with pytest.raises(NotImplementedError, match="segment-aware"):
        tmodel(torch.from_numpy(ids).long(),
               segment_ids=torch.from_numpy(seg).long())


def test_alibi_with_sparse_attention_raises_like_jax():
    sparse = object()
    with pytest.raises(ValueError, match="does not compose with alibi"):
        jlm.GPTConfig(**BLOOM, sparse_attention=sparse)
    with pytest.raises(ValueError, match="does not compose with alibi"):
        tlm.GPTConfig(**BLOOM, sparse_attention=sparse)


@pytest.mark.parametrize("alibi", [True, False])
def test_flash_requested_with_alibi_takes_einsum(monkeypatch, alibi):
    """JAX's gate (``not cfg.alibi``): a BLOOM forward with
    ``use_flash_attention=True`` never reaches the flash kernel and equals
    the einsum model; without ALiBi the same call does reach it."""
    calls = []
    real = fa.flash_attention

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(fa, "flash_attention", spy)
    fields = BLOOM if alibi else dict(BLOOM, alibi=False)
    _, params, flash = _pair(fields, flash=True)
    _, _, einsum = _pair(fields, flash=False)
    ids = torch.from_numpy(_ids(2, 128)).long()
    with torch.no_grad():
        got, want = flash(ids), einsum(ids)
    if alibi:
        assert not calls
        assert torch.equal(got, want)
    else:
        assert len(calls) == BASE["n_layer"]


@pytest.mark.parametrize("form", sorted(FORMS))
def test_bridge_and_exchange_layout_cover_every_parameter(form):
    """``gpt_state_dict_from_jax`` carries every leaf (``ln_embed``
    included) and ``gpt_exchange_layout`` lays the parameters out as
    ``jax.tree.flatten`` of the flax tree."""
    for scan_layers in (True, False):
        _, params, tmodel = _pair(FORMS[form], scan_layers=scan_layers)
        sd = gpt_state_dict_from_jax(params, tmodel.config)
        assert set(sd) == set(tmodel.state_dict())
        assert ("ln_embed.weight" in sd) == FORMS[form].get(
            "embed_layernorm", False)
        named = list(tmodel.named_parameters())
        layout = gpt_exchange_layout([(n, p.shape) for n, p in named],
                                     tmodel.config)
        leaves = flatten_jax_tree(params)
        assert [(p, s) for p, s in layout.leaves] == \
            [(p, tuple(a.shape)) for p, a in leaves]
        flat = torch.cat([torch.from_numpy(np.array(a, np.float32)).reshape(-1)
                          for _, a in leaves])
        for i, (name, prm) in enumerate(named):
            np.testing.assert_array_equal(layout.view(flat, i).numpy(),
                                          prm.detach().numpy(), err_msg=name)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_num_params_matches_jax(form):
    assert tlm.num_params(tlm.GPTConfig(**FORMS[form])) == \
        jlm.num_params(jlm.GPTConfig(**FORMS[form]))


def test_card_configs_are_the_published_widths():
    """The card phase's Pythia-6.9B (6,857,302,016 parameters) and
    BLOOM-7b1 (7,069,016,064) at their published widths; the port's
    parameters are JAX's leaves."""
    import chip_smoke

    for fields, n in ((chip_smoke.PYTHIA_6P9B, 6_857_302_016),
                      (chip_smoke.BLOOM_7B1, 7_069_016_064)):
        model = tlm.GPT(tlm.GPTConfig(**fields))
        assert sum(p.numel() for p in model.parameters()) == n
        shapes = jax.eval_shape(
            lambda: jlm.GPT(jlm.GPTConfig(**dict(fields, n_layer=1))).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
        one = tlm.GPT(tlm.GPTConfig(**dict(fields, n_layer=1)))
        assert sum(int(np.prod(x.shape)) for x in
                   jax.tree.leaves(shapes["params"])) == \
            sum(p.numel() for p in one.parameters())
    assert chip_smoke.PYTHIA_6P9B["rotary_pct"] == 0.25
    assert tlm.GPTConfig(**chip_smoke.PYTHIA_6P9B).rotary_dim == 32


def test_materialize_fills_ln_embed():
    cfg = tlm.GPTConfig(**BLOOM)
    model = tlm.GPT(cfg)
    tlm.materialize_gpt(model, "cpu", torch.Generator().manual_seed(0))
    assert bool((model.ln_embed.weight == 1).all())
    assert bool((model.ln_embed.bias == 0).all())
    assert model.wpe is None and model.lm_head is None
