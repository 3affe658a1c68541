"""The port's GPT against the JAX package's, on the same weights.

The flax model is initialised by jax, its parameter tree is carried over by
``gpt_state_dict_from_jax``, and both models see the same numpy token ids.
In f32 the two differ only in the order of sums (atol 1e-4 on logits of
order 1). On the flash path (T = 128) the JAX side runs the Pallas kernel in
interpret mode and the port its plain PyTorch version. The training path
(``labels``) is held to the loss and to every parameter gradient, the JAX
gradient tree carried over by the same bridge.
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
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

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
    params = cached_init(jmodel, seed, ids,
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
                             attention_mask=torch.from_numpy(mask),
                             decode=True)
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
    ("flash_autotune", True), ("sequence_parallel", "ulysses"),
    ("sequence_parallel", "ring"), ("param_offload", True),
])
def test_unported_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        tlm.GPTConfig(**{field: value})


@pytest.mark.parametrize("field,value,error", [
    ("quantized_weights", True, None), ("kv_cache_dtype", "int8", None),
    ("kv_cache_dtype", "fp8", ValueError),
])
def test_serving_config_fields_follow_jax(field, value, error):
    """``quantized_weights`` and ``kv_cache_dtype`` are ported: accepted as
    JAX's ``GPTConfig`` accepts them, and a KV cache dtype other than int8
    refused with its ValueError (:207-210)."""
    if error is None:
        assert getattr(tlm.GPTConfig(**{field: value}), field) == value
        return
    with pytest.raises(error) as terr:
        tlm.GPTConfig(**{field: value})
    with pytest.raises(error) as jerr:
        jlm.GPTConfig(**{field: value})
    assert str(terr.value) == str(jerr.value)


_OPAQUE_LAYOUT = object()


@pytest.mark.parametrize("field,value", [
    ("kv_cache_slack_blocks", 2), ("sparse_kv_cache", False),
    ("sparse_kv_cache", True), ("sparse_attention", _OPAQUE_LAYOUT),
])
def test_sparse_config_fields_follow_jax(field, value):
    """The block-sparse route and the ring cache are ported
    (``test_torch_sparse_gpt.py``): each of these values does in the port's
    ``GPTConfig`` what it does in the JAX one, side by side (accepted, or
    ``sparse_kv_cache=True`` without a ring-expressible layout refused with
    JAX's ValueError)."""
    try:
        jlm.GPTConfig(**{field: value})
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        assert getattr(tlm.GPTConfig(**{field: value}), field) is value
    else:
        with pytest.raises(ValueError) as got:
            tlm.GPTConfig(**{field: value})
        assert str(got.value) == want
    assert (field, value) != ("sparse_kv_cache", True) or want is not None


@pytest.mark.parametrize("field,value", [
    ("stochastic_mode", True), ("attention_chunk", 64),
    ("remat_policy", "selective"), ("remat_policy", "save_dots"),
    ("remat_policy", "save_nothing_but_flash"),
    ("use_flash_attention", "auto"), ("fused_head_ce", True),
    ("fused_head_ce", 2048), ("dropout", 0.1),
])
def test_training_option_fields_are_accepted(field, value):
    """The GPT training options ported in this package's A.6 slice: each
    config builds and a small model trains one step under it on the CPU
    (test_torch_remat_policies.py, test_torch_dropout.py,
    test_torch_stochastic_depth.py, test_torch_fused_ce.py and
    test_torch_chunked_attention.py hold each to JAX)."""
    cfg = tlm.GPTConfig(**SMALL, dtype=torch.float32, remat=True,
                        **{field: value})
    model = tlm.GPT(cfg)
    tlm.materialize_gpt(model, "cpu", torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_ids(2, 128, seed=1)).long()
    loss = model.train()(ids, labels=ids, pld_theta=torch.tensor(0.5),
                         dropout_generator=torch.Generator().manual_seed(1))
    loss.backward()
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


@pytest.mark.parametrize("field,value", [
    ("attention_chunk", 0), ("attention_chunk", 1.5),
    ("use_flash_attention", "yes"),
])
def test_bad_training_option_values_raise(field, value):
    with pytest.raises(ValueError, match=field):
        tlm.GPTConfig(**{field: value})


def test_config_fields_mirror_jax():
    jfields = {f.name: f.default for f in dataclasses.fields(jlm.GPTConfig)}
    tfields = {f.name: f.default for f in dataclasses.fields(tlm.GPTConfig)}
    assert list(tfields) == list(jfields)
    for name, default in jfields.items():
        if name not in ("dtype", "param_dtype"):
            assert tfields[name] == default, name


def _train_pair(flash=False, remat=False, bf16=False, seed=0):
    """(jax model, jax params, port model in training mode) on one set of
    weights, with the port's parameters requiring grad."""
    dt = dict(dtype=jnp.bfloat16 if bf16 else jnp.float32)
    jmodel = jlm.GPT(jlm.GPTConfig(**SMALL, use_flash_attention=flash,
                                   remat=remat, **dt))
    params = cached_init(jmodel, seed, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    tcfg = tlm.GPTConfig(**SMALL, use_flash_attention=flash, remat=remat,
                         dtype=torch.bfloat16 if bf16 else torch.float32)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(
        gpt_state_dict_from_jax(jax.device_get(params), tcfg), assign=True)
    tmodel.train()
    for prm in tmodel.parameters():
        prm.requires_grad_(True)
    return jmodel, params, tmodel


def _packed(b, t):
    """Three documents per row and a padded tail: segment ids and the
    positions that restart at each document."""
    seg = np.zeros((b, t), np.int32)
    pos = np.zeros((b, t), np.int32)
    for row, cuts in enumerate(([0, 40, 90, t - 10], [0, 70, 100, t - 3])):
        for doc, (a, e) in enumerate(zip(cuts[:-1], cuts[1:]), start=1):
            seg[row, a:e] = doc
            pos[row, a:e] = np.arange(e - a)
    return seg, pos


def _loss_and_grads(jmodel, params, tmodel, ids, **extra):
    """Both sides' loss and gradients; the JAX grads mapped to the port's
    parameter names."""
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
    return float(tl), float(jl), got, want


@pytest.mark.parametrize("case", ["einsum", "flash", "mask", "segments",
                                  "flash_segments", "remat", "flash_remat"])
def test_loss_and_every_gradient_match_jax(case):
    """f32 loss and every parameter gradient, relative to each gradient's
    largest entry: 1e-5 (the sides differ in the order of sums only)."""
    flash = case.startswith("flash")
    jmodel, params, tmodel = _train_pair(flash=flash, remat="remat" in case)
    ids = _ids(2, 128, seed=3)
    extra = {}
    if case == "mask":
        mask = np.ones((2, 128), np.int32)
        mask[1, -20:] = 0
        extra["attention_mask"] = mask
    if "segments" in case:
        extra["segment_ids"], extra["positions"] = _packed(2, 128)
    tl, jl, got, want = _loss_and_grads(jmodel, params, tmodel, ids, **extra)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= 1e-5 * scale + 1e-9, f"{name}: {err} of {scale}"


@pytest.mark.parametrize("flash", [False, True])
def test_full_remat_leaves_gradients_unchanged(flash):
    """remat=True with the "full" policy recomputes each block in the
    backward; the gradients are those of the model without remat."""
    ids = torch.from_numpy(_ids(2, 128, seed=4)).long()
    grads = []
    for remat in (False, True):
        _, _, tmodel = _train_pair(flash=flash, remat=remat)
        tmodel(ids, labels=ids).backward()
        grads.append({n: prm.grad for n, prm in tmodel.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=1e-7,
                                   msg=name)


@pytest.mark.parametrize("flash", [False, True])
def test_bf16_loss_tracks_jax(flash):
    """bf16 compute on both sides: the frameworks round to bf16 at different
    points, so the loss (~ln 128) is held to 1e-2 relative instead of the
    f32 bound."""
    jmodel, params, tmodel = _train_pair(flash=flash, bf16=True)
    ids = _ids(2, 128, seed=5)
    tl, jl, got, _ = _loss_and_grads(jmodel, params, tmodel, ids)
    assert abs(tl - jl) <= 1e-2 * abs(jl), (tl, jl)
    assert all(bool(torch.isfinite(g).all()) for g in got.values())


def test_dropout_acts_in_training_only():
    """Eval mode ignores dropout (the logits of the model without it); in
    training mode two generators give two losses, one generator state the
    same loss twice."""
    cfg = tlm.GPTConfig(**SMALL, dtype=torch.float32, dropout=0.1)
    tmodel = tlm.GPT(cfg)
    sd = gpt_state_dict_from_jax(jax.device_get(_pair()[1]), cfg)
    tmodel.load_state_dict(sd, assign=True)
    plain = tlm.GPT(dataclasses.replace(cfg, dropout=0.0))
    plain.load_state_dict(sd, assign=True)
    ids = torch.from_numpy(_ids(1, 16)).long()
    with torch.no_grad():
        assert torch.equal(tmodel.eval()(ids), plain.eval()(ids))
        tmodel.train()
        a, b, c = (tmodel(ids, labels=ids, dropout_generator=torch.Generator(
        ).manual_seed(s)) for s in (1, 2, 1))
    assert torch.equal(a, c) and not torch.equal(a, b)


@pytest.mark.parametrize("policy", ["selective", "save_dots",
                                    "save_nothing_but_flash"])
def test_remat_policies_other_than_full_train(policy):
    """Each policy's gradients equal full remat's (bit for bit on the CPU;
    test_torch_remat_policies.py holds them to JAX's)."""
    ids = torch.from_numpy(_ids(2, 128, seed=4)).long()
    grads = []
    for name in ("full", policy):
        jcfg = dict(flash=True, remat=True)
        _, _, tmodel = _train_pair(**jcfg)
        tmodel.config = dataclasses.replace(tmodel.config, remat_policy=name)
        tmodel(ids, labels=ids).backward()
        grads.append({n: p.grad for n, p in tmodel.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(grads[1][name], g), name


def test_fused_head_auto_engages_only_past_4gb(monkeypatch):
    """fused_head_ce="auto" keeps the unfused head below 4 GB of logits
    (transformer_lm.py:1189-1198) and takes the fused head + CE where JAX
    would fuse: the meta device shows the route without the memory."""
    from deepspeed_tpu_torch.ops import cross_entropy as tce

    seen = []
    real = tce.fused_linear_cross_entropy

    def spy(vocab_major, chunk, *args):
        seen.append(chunk)
        return real(vocab_major, chunk, *args)

    monkeypatch.setattr(tce, "fused_linear_cross_entropy", spy)
    for vocab, want in ((2 ** 20, [2048]), (2 ** 19, [])):
        seen.clear()
        cfg = tlm.GPTConfig(vocab_size=vocab, n_positions=2048, n_embd=32,
                            n_layer=0, n_head=1, dtype=torch.bfloat16)
        tmodel = tlm.GPT(cfg).to_empty(device="meta").train()
        ids = torch.zeros((1, 2048), dtype=torch.long, device="meta")
        assert tmodel(ids, labels=ids).shape == ()
        assert seen == want, vocab
