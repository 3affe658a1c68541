"""The port's mixture of experts (``deepspeed_tpu_torch/moe/``) against the
JAX package's (``deepspeed_tpu/moe/``), on the same inputs and the same
random draws.

The gating functions take their noise as tensors; each test draws it with
``jax.random`` in the JAX function's own split order (top-1: the RSample
gumbel from the first split, then the RTS uniforms from the next; top-2:
the gumbel of the key itself) and passes those numbers to the port, so
routing must agree exactly: ``exp_counts`` and the dispatch mask equal, the
f32 combine weights and ``l_aux`` to 1e-6 (one rounding of f32 softmax
sums, which XLA and torch order differently). The layer and the model run
in f32 at a small size (width 32-128, 4 experts): outputs to atol 1e-5 (MoE
layer) and 1e-4 (logits, as ``test_torch_llama.py``), the loss and every
gradient to 1e-5 of the gradient's largest entry. The index dispatch is a
copy (equal to the dense product bit for bit) and the index combine sums
the same <= k products as the dense f32 one (1e-6).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.moe import experts as jexperts
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.moe import utils as jutils
from deepspeed_tpu_torch import moe as tmoe
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import (flatten_jax_tree,
                                                           gpt_exchange_layout,
                                                           gpt_state_dict_from_jax)
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.runtime import moe_checkpoint as tckpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

GATE_ATOL = 1e-6
LAYER_ATOL = 1e-5
ATOL = 1e-4
GRAD_RTOL = 1e-5
T, E = 96, 4


def _logits(seed=0, t=T, e=E):
    return np.random.RandomState(seed).randn(t, e).astype(np.float32)


def _t(x):
    return torch.tensor(np.asarray(x))


def _top1_draws(key, shape, rsample, rts):
    """What ``top1_gating`` draws from ``key``, in its split order."""
    gumbel = uniform = None
    if rsample:
        key, sub = jax.random.split(key)
        gumbel = jax.random.gumbel(sub, shape, dtype=jnp.float32)
    if rts:
        key, sub = jax.random.split(key)
        uniform = jax.random.uniform(sub, shape, dtype=jnp.float32)
    return gumbel, uniform


def _assert_gating(got, want):
    np.testing.assert_array_equal(got.exp_counts.numpy(),
                                  np.asarray(want.exp_counts))
    np.testing.assert_array_equal(got.dispatch_mask.numpy(),
                                  np.asarray(want.dispatch_mask))
    np.testing.assert_allclose(got.combine_weights.numpy(),
                               np.asarray(want.combine_weights),
                               atol=GATE_ATOL, rtol=0)
    np.testing.assert_allclose(float(got.l_aux), float(want.l_aux),
                               atol=GATE_ATOL, rtol=0)


# (capacity_factor, min_capacity, drop_tokens, noisy_gate_policy, use_rts,
#  drawn): "drawn" passes an rng (noise) at all
TOP1_CASES = {
    "drop": (1.0, 4, True, None, False, False),
    "drop_tight": (0.5, 2, True, None, False, False),
    "no_drop": (0.5, 4, False, None, False, False),
    "min_capacity": (0.1, 30, True, None, False, False),
    "capacity_past_tokens": (8.0, 4, True, None, False, False),
    "rts": (0.5, 4, True, None, True, True),
    "rts_capacity_past_tokens": (8.0, 4, True, None, True, True),
    "rsample": (1.0, 4, True, "RSample", False, True),
    "rsample_rts": (0.5, 4, True, "RSample", True, True),
    "rsample_rts_no_drop": (0.5, 4, False, "RSample", True, True),
    "rts_without_rng": (0.5, 4, True, None, True, False),
}


@pytest.mark.parametrize("case", sorted(TOP1_CASES))
def test_top1_gating_matches_jax(case):
    cf, minc, drop, policy, rts, drawn = TOP1_CASES[case]
    logits = _logits(1)
    key = jax.random.PRNGKey(7) if drawn else None
    want = jsm.top1_gating(jnp.asarray(logits), cf, minc, rng=key,
                           noisy_gate_policy=policy, drop_tokens=drop,
                           use_rts=rts)
    gumbel = uniform = None
    if drawn:
        gumbel, uniform = _top1_draws(key, logits.shape,
                                      policy == "RSample", rts)
    got = tsm.top1_gating(_t(logits), cf, minc,
                          gumbel=None if gumbel is None else _t(gumbel),
                          uniform=None if uniform is None else _t(uniform),
                          noisy_gate_policy=policy, drop_tokens=drop,
                          use_rts=rts)
    _assert_gating(got, want)
    assert got.routing.capacity == want.combine_weights.shape[2]


def test_top1_used_token_matches_jax():
    logits = _logits(2)
    used = (np.arange(T) % 3 != 0)
    want = jsm.top1_gating(jnp.asarray(logits), 1.0, 4, use_rts=False,
                           used_token=jnp.asarray(used))
    got = tsm.top1_gating(_t(logits), 1.0, 4, use_rts=False,
                          used_token=_t(used))
    _assert_gating(got, want)


@pytest.mark.parametrize("drawn", [False, True])
@pytest.mark.parametrize("cf,minc", [(1.0, 4), (0.25, 2), (0.05, 40),
                                     (4.0, 4)])
def test_top2_gating_matches_jax(cf, minc, drawn):
    """Renormalised weights over the kept choices; the second choice's
    locations start after every first choice; capacity from 2 x the
    factor (and at most the token count)."""
    logits = _logits(3)
    key = jax.random.PRNGKey(9) if drawn else None
    want = jsm.top2_gating(jnp.asarray(logits), cf, minc, rng=key)
    gumbel = (jax.random.gumbel(key, logits.shape, dtype=jnp.float32)
              if drawn else None)
    got = tsm.top2_gating(_t(logits), cf, minc,
                          gumbel=None if gumbel is None else _t(gumbel))
    _assert_gating(got, want)


@pytest.mark.parametrize("name,value", [
    ("noisy_gate_policy", "RSample"), ("drop_tokens", False),
    ("use_rts", False), ("used_token", np.ones(T, bool))])
def test_top2_refuses_top1_options_like_jax(name, value):
    logits = _logits(4)
    # JAX compares the option to its default with !=, which an array
    # (used_token) answers elementwise: its refusal is numpy's ValueError
    words = None if name == "used_token" else f"does not support {name}"
    with pytest.raises(ValueError, match=words):
        jsm.topk_gating(jnp.asarray(logits), 2, **{
            name: jnp.asarray(value) if isinstance(value, np.ndarray)
            else value})
    with pytest.raises(ValueError, match=f"does not support {name}"):
        tsm.topk_gating(_t(logits), 2, **{
            name: _t(value) if isinstance(value, np.ndarray) else value})
    with pytest.raises(ValueError, match="only top-1 and top-2"):
        tsm.topk_gating(_t(logits), 3)


def test_static_capacity_matches_jax():
    for args in [(96, 4, 1.0, 4), (96, 4, 0.1, 4), (96, 4, 8.0, 4),
                 (7, 8, 1.25, 1), (8192, 8, 4.0, 4), (1, 8, 8.0, 4)]:
        assert tsm.static_capacity(*args) == jsm.static_capacity(*args)


@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_and_combine_dense_and_by_index_match_jax(k):
    """The same gating output (top-1 with RTS dropping tokens, or top-2 at
    a tight capacity) through the dense one-hot products and the index
    form, against JAX's dense products."""
    logits = _logits(5)
    key = jax.random.PRNGKey(3)
    if k == 1:
        want = jsm.top1_gating(jnp.asarray(logits), 0.5, 2, rng=key)
        _, uniform = _top1_draws(key, logits.shape, False, True)
        got = tsm.top1_gating(_t(logits), 0.5, 2, uniform=_t(uniform))
    else:
        want = jsm.top2_gating(jnp.asarray(logits), 0.25, 2, rng=key)
        got = tsm.top2_gating(_t(logits), 0.25, 2, gumbel=_t(
            jax.random.gumbel(key, logits.shape, dtype=jnp.float32)))
    rng = np.random.RandomState(6)
    x = rng.randn(T, 16).astype(np.float32)
    C = got.routing.capacity
    eo = rng.randn(E, C, 16).astype(np.float32)
    jd = np.asarray(jsm.dispatch_tokens(want.dispatch_mask, jnp.asarray(x)))
    jc = np.asarray(jsm.combine_tokens(want.combine_weights, jnp.asarray(eo)))
    dense_d = tsm.dispatch_tokens(got.dispatch_mask, _t(x))
    index_d = tsm.dispatch_by_index(got.routing, _t(x))
    assert torch.equal(dense_d, index_d)
    np.testing.assert_array_equal(index_d.numpy(), jd)
    for fn, w in ((tsm.combine_tokens, got.combine_weights),
                  (tsm.combine_by_index, got.routing)):
        np.testing.assert_allclose(fn(w, _t(eo)).numpy(), jc,
                                   atol=GATE_ATOL, rtol=0)
    assert int(got.routing.kept.sum()) < k * T  # some choices dropped


def test_index_combine_gradients_equal_the_dense_ones():
    """The combine's backward: the expert outputs' gradient and the
    weights' (which reach the gate) agree between the two forms."""
    logits = _t(_logits(7)).requires_grad_(True)
    gumbel = _t(jax.random.gumbel(jax.random.PRNGKey(1), (T, E)))
    C = tsm.static_capacity(T, E, 0.5, 4)
    eo = torch.randn(E, C, 8, generator=torch.Generator().manual_seed(0))
    dy = torch.randn(T, 8, generator=torch.Generator().manual_seed(1))
    grads = []
    for dense in (True, False):
        lg = logits.detach().clone().requires_grad_(True)
        e = eo.clone().requires_grad_(True)
        g = tsm.top2_gating(lg, 0.25, 4, gumbel=gumbel)
        y = (tsm.combine_tokens(g.combine_weights, e) if dense
             else tsm.combine_by_index(g.routing, e))
        grads.append(torch.autograd.grad((y * dy).sum(), (lg, e)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("gated", [False, True])
def test_stacked_experts_match_jax(gated):
    """Gated (SwiGLU, no biases) and biased (tanh GELU) experts, weights
    from flax's init (the expert axis first)."""
    jmod = jexperts.StackedExperts(num_experts=E, d_model=32, d_hidden=48,
                                   dtype=jnp.float32, gated=gated,
                                   use_bias=not gated,
                                   activation=jax.nn.silu if gated
                                   else jax.nn.gelu)
    x = np.random.RandomState(8).randn(E, 10, 32).astype(np.float32)
    params = cached_init(jmod, 0, jnp.asarray(x))["params"]
    if not gated:
        params = dict(params, bi=jnp.full((E, 48), 0.1),
                      bo=jnp.full((E, 32), -0.2))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    tmod = tmoe.StackedExperts(E, 32, 48, dtype=torch.float32, gated=gated,
                               use_bias=not gated)
    tmod.load_state_dict({k: _t(v) for k, v in params.items()})
    with torch.no_grad():
        got = tmod(_t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=LAYER_ATOL, rtol=0)


def _moe_pair(k, gated, **over):
    kw = dict(d_model=32, d_hidden=48, num_experts=E, k=k,
              capacity_factor=0.75, eval_capacity_factor=2.0,
              min_capacity=2, gated_experts=gated, **over)
    jmod = jlayer.MoE(**kw, dtype=jnp.float32)
    x = np.random.RandomState(10).randn(2, 24, 32).astype(np.float32)
    params = cached_init(jmod, 2, jnp.asarray(x))["params"]
    tmod = tmoe.MoE(**kw, dtype=torch.float32)
    sd = {"gate.weight": _t(params["gate"]["kernel"]).t()}
    sd.update({f"experts.{n}": _t(v) for n, v in params["experts"].items()})
    tmod.load_state_dict(sd)
    return jmod, params, tmod, x


def _capture_gating_rng(monkeypatch):
    """Record the key JAX's ``MoE`` hands to ``topk_gating`` (flax derives
    it from the ``gating`` stream and the module's path)."""
    seen = []
    real = jlayer.topk_gating

    def spy(logits, k, rng=None, **kw):
        seen.append(rng)
        return real(logits, k, rng=rng, **kw)

    monkeypatch.setattr(jlayer, "topk_gating", spy)
    return seen


# (k, gated, training, extra MoE fields)
LAYER_CASES = {
    "top1_eval": (1, False, False, {}),
    "top1_train_rts": (1, False, True, {}),
    "top1_train_rsample_rts": (1, False, True,
                               {"noisy_gate_policy": "RSample"}),
    "top1_train_no_drop": (1, True, True, {"drop_tokens": False,
                                           "use_rts": False}),
    "top2_eval_gated": (2, True, False, {}),
    "top2_train_gated": (2, True, True, {}),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_layer_matches_jax(case, monkeypatch):
    """``(y, l_aux, exp_counts)`` at the eval capacity (no noise) or the
    training capacity with the noise JAX's layer drew, in its order."""
    k, gated, training, over = LAYER_CASES[case]
    jmod, params, tmod, x = _moe_pair(k, gated, **over)
    seen = _capture_gating_rng(monkeypatch)
    rngs = {"gating": jax.random.PRNGKey(5)} if training else None
    want = jmod.apply({"params": params}, jnp.asarray(x),
                      deterministic=not training, rngs=rngs)
    noise = None
    if training:
        key, shape = seen[0], (x.shape[0] * x.shape[1], E)
        kinds = tmod.noise_kinds()
        if k == 2:
            draws = [jax.random.gumbel(key, shape, dtype=jnp.float32)]
        else:
            g, u = _top1_draws(key, shape, "gumbel" in kinds,
                               "uniform" in kinds)
            draws = [d for d in (g, u) if d is not None]
        noise = torch.stack([_t(d) for d in draws]) if draws else None
    tmod.train(training)
    with torch.no_grad():
        y, l_aux, counts = tmod(_t(x), noise=noise)
    np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                               atol=LAYER_ATOL, rtol=0)
    np.testing.assert_allclose(float(l_aux), float(want[1]),
                               atol=GATE_ATOL, rtol=0)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[2]))


def test_moe_layer_equals_its_dense_plain_version():
    """The layer (index dispatch and combine) against the same gate,
    gating and experts through the dense one-hot products."""
    _, _, tmod, x = _moe_pair(2, True)
    tmod.train()
    tokens = _t(x).reshape(-1, 32)
    noise = torch.rand(1, 48, E, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y, _, counts = tmod(_t(x), noise=noise)
        g = tsm.topk_gating(tmod.gate(tokens), 2, capacity_factor=0.75,
                            min_capacity=2, gumbel=noise[0])
        want = tsm.combine_tokens(
            g.combine_weights,
            tmod.experts(tsm.dispatch_tokens(g.dispatch_mask, tokens)))
    torch.testing.assert_close(y.reshape(-1, 32), want, atol=GATE_ATOL,
                               rtol=0)
    assert torch.equal(counts, g.exp_counts)


# a Mixtral-shaped GPT (mixtral_from_hf's fields, hf.py:590) at a small
# size: the LLaMA trunk with 4 gated experts, top-2, GQA
MIXTRAL = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
               n_head=4, n_kv_head=2, intermediate_size=96,
               layer_norm_epsilon=1e-5, norm="rmsnorm", activation="silu",
               use_bias=False, rotary=True, rope_theta=1e6,
               learned_positions=False, tie_word_embeddings=False,
               moe_num_experts=4, moe_top_k=2, moe_gated_experts=True,
               moe_aux_loss_coef=0.02, moe_capacity_factor=1.0,
               moe_eval_capacity_factor=2.0, dropout=0.0)
SWITCH = dict(vocab_size=256, n_positions=128, n_embd=64, n_layer=2,
              n_head=4, moe_num_experts=4, moe_top_k=1,
              moe_capacity_factor=1.0, moe_eval_capacity_factor=1.5,
              dropout=0.0)


def _pair(fields, scan_layers=True, flash=False, train=False, **over):
    fields = dict(fields, **over)
    jmodel = jlm.GPT(jlm.GPTConfig(**fields, scan_layers=scan_layers,
                                   use_flash_attention=flash,
                                   dtype=jnp.float32))
    params = jax.device_get(cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
        deterministic=True)["params"])
    tcfg = tlm.GPTConfig(**fields, scan_layers=scan_layers,
                         use_flash_attention=flash, dtype=torch.float32)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(gpt_state_dict_from_jax(params, tcfg), assign=True)
    tmodel.train(train)
    for p in tmodel.parameters():
        p.requires_grad_(train)
    return jmodel, params, tmodel


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, 256, size=(b, t)).astype(
        np.int32)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("form", ["mixtral", "switch"])
def test_moe_gpt_logits_match_jax(form, scan_layers):
    jmodel, params, tmodel = _pair(MIXTRAL if form == "mixtral" else SWITCH,
                                   scan_layers=scan_layers)
    ids = _ids(2, 64)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   deterministic=True))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_moe_gpt_decode_matches_jax():
    """Prefill 6 left-padded tokens, then 4 decode steps, through the
    experts at the eval capacity (each call routes its own tokens)."""
    jmodel, params, tmodel = _pair(MIXTRAL)
    ids = _ids(2, 10, seed=1)
    mask = np.ones((2, 6), bool)
    mask[0, :2] = False
    jpre, jcache = jmodel.apply(
        {"params": params}, jnp.asarray(ids[:, :6]),
        attention_mask=jnp.asarray(mask), deterministic=True, decode=True,
        mutable=["cache"])
    with torch.no_grad():
        tpre, cache = tmodel(torch.from_numpy(ids[:, :6]).long(),
                             attention_mask=torch.from_numpy(mask),
                             decode=True)
    np.testing.assert_allclose(tpre.numpy()[mask], np.asarray(jpre)[mask],
                               atol=ATOL, rtol=0)
    jcache = jcache["cache"]
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


def _assert_grads(tmodel, jgrads):
    want = gpt_state_dict_from_jax(jax.device_get(jgrads), tmodel.config)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        scale = float(want[name].abs().max())
        err = float((g - want[name]).abs().max())
        assert err <= GRAD_RTOL * scale + 1e-9, f"{name}: {err} of {scale}"


@pytest.mark.parametrize("case", ["mixtral", "mixtral_flash_remat",
                                  "mixtral_unscanned", "switch"])
def test_moe_gpt_loss_and_every_gradient_match_jax(case):
    """Training capacity, no noise (JAX applied with no ``gating`` rng):
    the cross entropy plus ``moe_aux_loss_coef`` times the layers' mean
    ``l_aux``, and every gradient, the gates' and experts' included."""
    fields = SWITCH if case == "switch" else MIXTRAL
    jmodel, params, tmodel = _pair(
        fields, scan_layers=case != "mixtral_unscanned",
        flash=case == "mixtral_flash_remat", train=True,
        remat=case == "mixtral_flash_remat")
    ids = _ids(2, 128 if case == "mixtral_flash_remat" else 48, seed=3)

    def jloss(p):
        return jmodel.apply({"params": p}, jnp.asarray(ids),
                            labels=jnp.asarray(ids), deterministic=False)

    jl, jg = jax.value_and_grad(jloss)(params)
    tl = tmodel(torch.from_numpy(ids).long(),
                labels=torch.from_numpy(ids).long())
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= GRAD_RTOL * abs(float(jl))
    _assert_grads(tmodel, jg)
    assert float(tmodel.h[0].mlp.gate.weight.grad.abs().max()) > 0


def _noise(tmodel, tokens, seed=0):
    kinds = tmodel.h[0].mlp.noise_kinds()
    cfg = tmodel.config
    out = torch.empty((cfg.n_layer, len(kinds), tokens, cfg.moe_num_experts))
    return tmoe.draw_gating_noise(out, kinds,
                                  torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("form", ["mixtral", "switch_rsample_rts"])
def test_remat_recompute_routes_as_the_forward(form):
    """Under the same noise, full remat and no remat give equal losses and
    gradients: the recompute routes every token as the forward did. Other
    noise routes otherwise (the noise is used)."""
    fields = (MIXTRAL if form == "mixtral"
              else dict(SWITCH, moe_noisy_gate_policy="RSample",
                        moe_capacity_factor=0.5))
    ids = torch.from_numpy(_ids(2, 48, seed=4)).long()
    results = []
    for remat, seed in ((False, 0), (True, 0), (False, 1)):
        _, _, tmodel = _pair(fields, train=True, remat=remat)
        noise = _noise(tmodel, ids.numel(), seed)
        loss = tmodel(ids, labels=ids, gating_noise=noise)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in
                                        tmodel.named_parameters()}))
    (l0, g0), (l1, g1), (l2, _) = results
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert not torch.equal(l0, l2)


def test_noise_kinds_follow_the_jax_split_order():
    assert tmoe.gating_noise_kinds(1, None, True) == ("uniform",)
    assert tmoe.gating_noise_kinds(1, "RSample", True) == ("gumbel",
                                                           "uniform")
    assert tmoe.gating_noise_kinds(1, "RSample", False) == ("gumbel",)
    assert tmoe.gating_noise_kinds(1, None, False) == ()
    assert tmoe.gating_noise_kinds(2, None, True) == ("gumbel",)


def test_drawn_noise_has_the_gumbel_and_uniform_laws():
    out = torch.empty(2, 200000, 1)
    tmoe.draw_gating_noise(out, ("gumbel", "uniform"),
                           torch.Generator().manual_seed(0))
    g, u = out[0].flatten(), out[1].flatten()
    assert 0 <= float(u.min()) and float(u.max()) < 1
    assert abs(float(u.mean()) - 0.5) < 5e-3
    assert abs(float(g.mean()) - 0.5772) < 1e-2        # Euler's constant
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 3e-2


@pytest.mark.parametrize("scan_layers", [True, False])
def test_bridge_and_exchange_layout_cover_the_experts(scan_layers):
    """Every flax leaf reaches the port (the gate transposed, the experts
    in JAX's layout) and ``gpt_exchange_layout`` is the JAX flat layout."""
    _, params, tmodel = _pair(MIXTRAL, scan_layers=scan_layers)
    sd = gpt_state_dict_from_jax(params, tmodel.config)
    assert set(sd) == set(tmodel.state_dict())
    assert tuple(sd["h.0.mlp.experts.wi"].shape) == (4, 128, 96)
    assert tuple(sd["h.0.mlp.experts.wo"].shape) == (4, 96, 128)
    assert tuple(sd["h.0.mlp.gate.weight"].shape) == (4, 128)
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


def test_materialize_keeps_the_gate_f32_and_draws_lecun_over_e_m():
    """Under a bf16 ``param_dtype`` the gate stays f32 (JAX's
    ``param_dtype=jnp.float32``); a serving dtype casts it too. The experts'
    truncated lecun init counts the expert axis in the fan-in."""
    cfg = tlm.GPTConfig(**dict(MIXTRAL, n_embd=256, intermediate_size=512),
                        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = tlm.GPT(cfg)
    tlm.materialize_gpt(model, "cpu", torch.Generator().manual_seed(0))
    mlp = model.h[0].mlp
    assert mlp.gate.weight.dtype == torch.float32
    assert mlp.experts.wi.dtype == torch.bfloat16
    for name, fan in (("wi", 4 * 256), ("wg", 4 * 256), ("wo", 4 * 512)):
        std = float(getattr(mlp.experts, name).float().std())
        assert abs(std - fan ** -0.5) < 0.05 * fan ** -0.5, name
    served = tlm.GPT(cfg)
    tlm.materialize_gpt(served, "cpu", torch.Generator().manual_seed(0),
                        dtype=torch.bfloat16)
    assert served.h[0].mlp.gate.weight.dtype == torch.bfloat16


def test_num_params_counts_experts_as_jax_does():
    """The reference quirk kept: ``num_params`` counts one dense MLP for a
    mixture of experts (no experts, no gate)."""
    for fields in (MIXTRAL, SWITCH):
        cfg = tlm.GPTConfig(**fields)
        assert tlm.num_params(cfg) == jlm.num_params(jlm.GPTConfig(**fields))
        assert tlm.num_params(cfg) < sum(p.numel() for p in
                                         tlm.GPT(cfg).parameters())


@pytest.mark.parametrize("path,ndim", [
    ("h/block/mlp/experts/wi", 4), ("h/block/mlp/experts/bo", 3),
    ("h_0/mlp/experts/wg", 3), ("h_0/mlp/experts/bi", 2),
    ("h_0/mlp/experts/bi", 1), ("h_0/mlp/c_fc/kernel", 2),
    ("h_0/mlp/gate/kernel", 2), ("mu/h_0/mlp/experts/wo", 3)])
def test_expert_axis_and_utils_match_jax(path, ndim):
    assert tmoe.expert_axis(path, ndim) == jlayer.expert_axis(path, ndim)
    dotted = path.replace("/", ".")
    assert tmoe.expert_axis(dotted, ndim) == jlayer.expert_axis(path, ndim)
    assert tmoe.is_moe_param_path(dotted) == jutils.is_moe_param_path(path)


def test_split_moe_params():
    _, _, tmodel = _pair(MIXTRAL)
    expert, dense = tmoe.split_moe_params(tmodel.named_parameters())
    assert {n for n, _ in expert} == {
        f"h.{i}.mlp.experts.{w}" for i in range(2) for w in ("wi", "wg", "wo")}
    assert len(expert) + len(dense) == len(list(tmodel.parameters()))


def test_expert_checkpoint_split_and_merge_round_trip():
    """A model state and an optimizer state split into one slice per
    expert and merged back: every tensor equal, the dense part untouched."""
    _, _, tmodel = _pair(MIXTRAL)
    sd = {k: v.clone() for k, v in tmodel.state_dict().items()}
    optim = {"count": 3, "state": {n: {"exp_avg": v * 2, "exp_avg_sq": v * 3}
                                   for n, v in sd.items()}}
    for payload in ({"module": sd}, {"optimizer": optim, "loss_scale": {}}):
        info = tckpt.find_expert_leaves(payload)
        assert len(info) == (6 if "module" in payload else 12)
        dense, meta, n = tckpt.split_expert_state(payload, info)
        assert n == 4
        slices = {e: tckpt.expert_slice(payload, info, e) for e in range(n)}
        assert all(x.shape[0] in (128, 96)
                   for s in slices.values() for x in s.values())
        merged = tckpt.merge_expert_slices(dense, meta, slices)
        flat_a, flat_b = tckpt._flatten(payload), tckpt._flatten(merged)
        assert set(flat_a) == set(flat_b)
        for k, v in flat_a.items():
            if torch.is_tensor(v):
                assert torch.equal(v, flat_b[k]), k
            else:
                assert v == flat_b[k], k
    assert tckpt.expert_states_filename(3, "optim") == \
        "expert_3_mp_rank_00_optim_states.pt"
