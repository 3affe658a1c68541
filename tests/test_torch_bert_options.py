"""BERT's training options against the JAX package: dropout, stochastic
depth under progressive layer drop and the four ``remat_policy`` names.

The port draws its masks from a ``torch.Generator`` (the engine's), JAX
from its ``dropout`` key, so the draws differ by design. The model is held
to JAX where the masks do not matter (eval mode; every layer kept at theta
1) and, with the same masks handed to both (JAX's ``jax.random.bernoulli``
replaced by the port's draws, site for site), in training: on the einsum
path (1 + 3L masks: the embedding, then per layer the probabilities, the
attention output and the MLP output) and on the block-sparse ``"gather"``
and ``"pallas"`` routes (1 + 2L: no probability dropout there; the JAX
side runs its Pallas kernels in interpret mode, the port the plain B5-B7).
The JAX model runs in the loop form (``scan_layers=False``), because a scan
traces its body once. The recompute's reuse of the masks and gates, the
policies' equality with ``full``, the block-sparse forward's count per
policy, the engine's generator and theta and the gradient exchange's BERT
layout are the port's own.

Tolerances: f32 throughout; losses to 1e-5 relative, each gradient to 1e-5
of its largest entry, logits to 1e-4 absolute (``test_torch_bert.py``'s
bound on logits of order 1).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops.sparse_attention import sparse_attention_utils as jutils
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JaxPLD
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.module_inject.jax_params import (
    bert_exchange_layout, bert_state_dict_from_jax, flatten_jax_tree)
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.sparse_attention import \
    sparse_attention_utils as tutils
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64)
L = TINY["num_hidden_layers"]
T = 64
RATE = 0.1
BIGBIRD = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
           "num_sliding_window_blocks": 3, "num_global_blocks": 1}
POLICIES = ("full", "selective", "save_dots", "save_nothing_but_flash")
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
LOGIT_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _clean():
    ac.reset()
    yield
    ac.reset()


def _configs(kernel=None, jax_over=None, **over):
    """(flax config, port config) in the loop form, with the sparse block
    of ``kernel`` ("gather", "pallas") or full attention (None);
    ``jax_over`` overrides fields of the flax config alone."""
    jcfg = jbert.BertConfig(**TINY, dtype=jnp.float32, param_dtype=jnp.float32,
                            scan_layers=False,
                            **dict(over, **(jax_over or {})))
    tcfg = tbert.BertConfig(**TINY, dtype=torch.float32, scan_layers=False,
                            **over)
    if kernel is not None:
        block = dict(BIGBIRD, kernel=kernel)
        jcfg = dataclasses.replace(
            jcfg, sparse_attention=jutils.get_sparse_attention_config(
                dict(block), TINY["num_attention_heads"]))
        tcfg = dataclasses.replace(
            tcfg, sparse_attention=tutils.get_sparse_attention_config(
                dict(block), TINY["num_attention_heads"]))
    return jcfg, tcfg


def _both(kernel=None, seed=0, jax_over=None, **over):
    jcfg, tcfg = _configs(kernel, jax_over, **over)
    jmodel = jbert.BertForPreTraining(jcfg)
    params = jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, T), jnp.int32))["params"])
    tmodel = tbert.BertForPreTraining(tcfg)
    tmodel.load_state_dict(bert_state_dict_from_jax(params, tcfg),
                           assign=True)
    for p in tmodel.parameters():
        p.requires_grad_(True)
    return jmodel, params, tmodel


def _batch(seed=0, b=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], size=(b, T)).astype(np.int32)
    labels = np.where(rng.rand(b, T) < 0.15, ids, -100).astype(np.int32)
    labels[:, 0] = ids[:, 0]                 # at least one label per row
    return {"input_ids": ids, "labels": labels,
            "token_type_ids": (rng.rand(b, T) < 0.5).astype(np.int32)}


def _torch_batch(batch):
    return {k: torch.tensor(v).long() for k, v in batch.items()}


def _jax_train(jmodel, params, batch, **kw):
    """JAX's training apply: the loss and its gradient tree."""
    def loss(p):
        return jmodel.apply({"params": p},
                            **{k: jnp.asarray(v) for k, v in batch.items()},
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)}, **kw)

    return jax.value_and_grad(loss)(params)


def _assert_matches(tl, tmodel, jl, jg):
    tl, jl = float(tl.detach()), float(jl)
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)
    want = bert_state_dict_from_jax(jax.device_get(jg), tmodel.config)
    for name, p in tmodel.named_parameters():
        scale = float(want[name].abs().max())
        err = float((p.grad - want[name]).abs().max())
        assert err <= GRAD_RTOL * scale + 1e-9, f"{name}: {err} of {scale}"


@pytest.mark.parametrize("kernel", [None, "gather", "pallas"],
                         ids=["dense", "gather", "pallas"])
def test_given_masks_training_matches_jax(kernel, monkeypatch):
    """The same masks on both sides (the port's draws, in its order, handed
    to JAX's ``bernoulli`` at each site): loss and every gradient of JAX's
    training apply, the port under full remat. A dense BERT draws 1 + 3L
    masks, a block-sparse one 1 + 2L. (The JAX BERT runs without remat:
    its ``nn.remat`` traces ``deterministic``, which its dropout and its
    layer gate branch on, so it trains under remat only at rate 0 and
    without stochastic depth; remat changes no value.)"""
    jmodel, params, tmodel = _both(kernel, dropout=RATE, remat=True,
                                   jax_over={"remat": False})
    batch = _batch(seed=2)
    gen = torch.Generator().manual_seed(5)
    masks = []
    real_draw = ac.bernoulli_mask

    def recording(shape, p, generator, device):
        m = real_draw(shape, p, generator, device)
        draws = getattr(ac.checkpointing._current, "draws", None)
        if draws is None or not draws.replaying:
            masks.append((tuple(shape), p, m.numpy().copy()))
        return m

    monkeypatch.setattr(ac, "bernoulli_mask", recording)
    tl = tmodel.train()(**_torch_batch(batch), dropout_generator=gen)
    tl.backward()
    assert len(masks) == 1 + (2 if kernel else 3) * L

    handed = iter(masks)

    def given(key, p=0.5, shape=None):
        want_shape, want_p, m = next(handed)
        assert tuple(shape) == want_shape
        assert math.isclose(float(p), want_p)
        return jnp.asarray(m)

    monkeypatch.setattr(jax.random, "bernoulli", given)
    jl, jg = _jax_train(jmodel, params, batch)
    _assert_matches(tl, tmodel, jl, jg)


@pytest.mark.parametrize("kernel", [None, "gather", "pallas"],
                         ids=["dense", "gather", "pallas"])
def test_eval_mode_ignores_dropout(kernel):
    """Eval mode draws nothing: the logits of JAX's deterministic apply at
    dropout 0.1, and no call to the mask draw."""
    jmodel, params, tmodel = _both(kernel, seed=1, dropout=RATE,
                                   stochastic_mode=True)
    batch = {k: v for k, v in _batch(seed=3).items() if k != "labels"}
    want = np.asarray(jmodel.apply(
        {"params": params}, **{k: jnp.asarray(v) for k, v in batch.items()},
        deterministic=True))
    with torch.no_grad():
        got = tmodel.eval()(**_torch_batch(batch),
                            dropout_generator=torch.Generator().manual_seed(0),
                            pld_theta=torch.tensor(0.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("remat", [False, True])
def test_pld_at_theta_one_trains_as_jax(remat):
    """At theta 1 every layer is kept (keep 1 - (i / L) * 0): the loss and
    every gradient of JAX's training apply with pld_theta 1.0 (the JAX
    BERT without remat, as in the given-masks test)."""
    jmodel, params, tmodel = _both("pallas", seed=2, stochastic_mode=True,
                                   remat=remat, jax_over={"remat": False})
    batch = _batch(seed=4)
    jl, jg = _jax_train(jmodel, params, batch, pld_theta=1.0)
    tl = tmodel.train()(**_torch_batch(batch), pld_theta=torch.tensor(1.0),
                        dropout_generator=torch.Generator().manual_seed(0))
    tl.backward()
    _assert_matches(tl, tmodel, jl, jg)


def test_dropped_layers_are_identities_and_recompute_reuses_gates():
    """At theta 0 (keep 1 - i/L) a dropped layer hands its input on; remat
    on and off draw the same gates and give the same loss and gradients
    from one generator state, bit for bit; eval mode runs every layer."""
    batch = _torch_batch(_batch(seed=5))
    out = []
    for remat in (False, True):
        tmodel = _deep(remat)
        gen = torch.Generator().manual_seed(11)
        loss = tmodel.train()(**batch, pld_theta=torch.tensor(0.0),
                              dropout_generator=gen)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    tmodel.named_parameters()},
                    gen.get_state()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][2], out[1][2])
    for name, g in out[0][1].items():
        assert torch.equal(out[1][1][name], g), name
    # the gates of that draw (the embedding's mask is drawn first): a
    # dropped layer's parameters get no gradient
    gen = torch.Generator().manual_seed(11)
    ac.bernoulli_mask((2, T, TINY["hidden_size"]), 1 - RATE, gen, "cpu")
    gates = torch.rand(DEEP, generator=gen) < (1 - torch.arange(DEEP) / DEEP)
    assert not bool(gates.all()), "this seed should drop a layer"
    for i, kept in enumerate(gates.tolist()):
        g = out[0][1][f"encoder.layer.{i}.intermediate.weight"]
        assert bool(g.abs().sum() > 0) == kept, i
    with torch.no_grad():
        a = tmodel.eval()(**batch, pld_theta=torch.tensor(0.0))
        b = tmodel.eval()(**batch)
    assert torch.equal(a, b)


DEEP = 6


def _deep(remat):
    """A 6-layer port BERT (no JAX twin) in stochastic mode with dropout."""
    torch.manual_seed(0)
    cfg = tbert.BertConfig(**dict(TINY, num_hidden_layers=DEEP),
                           dtype=torch.float32, stochastic_mode=True,
                           remat=remat, dropout=RATE)
    model = tbert.BertForPreTraining(cfg)
    tbert.materialize_bert(model, "cpu", torch.Generator().manual_seed(3))
    for p in model.parameters():
        p.requires_grad_(True)
    return model


@pytest.mark.parametrize("kernel", [None, "pallas"], ids=["dense", "pallas"])
@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax(policy, kernel):
    """Each policy's loss and gradients against JAX's
    ``nn.remat(policy=_remat_policy(name))`` of the same BERT (training
    apply at rate 0: nothing is drawn)."""
    jmodel, params, tmodel = _both(kernel, seed=3, remat=True,
                                   remat_policy=policy)
    batch = _batch(seed=6)
    jl, jg = _jax_train(jmodel, params, batch)
    tl = tmodel.train()(**_torch_batch(batch))
    tl.backward()
    _assert_matches(tl, tmodel, jl, jg)


@pytest.mark.parametrize("kernel", [None, "gather", "pallas"],
                         ids=["dense", "gather", "pallas"])
def test_policies_equal_full_under_dropout_and_pld(kernel):
    """Under dropout 0.1 and stochastic depth, from one generator state,
    every policy gives ``full``'s loss and gradients bit for bit, and the
    model without remat gives them too: a policy changes what is saved,
    never a value, and the recompute sees the forward's masks and gates."""
    batch = _torch_batch(_batch(seed=7))
    runs = {}
    for policy in (None,) + POLICIES:
        over = {} if policy is None else dict(remat=True, remat_policy=policy)
        *_, tmodel = _both(kernel, seed=4, dropout=RATE,
                           stochastic_mode=True, jax_over={"remat": False},
                           **over)
        gen = torch.Generator().manual_seed(13)
        loss = tmodel.train()(**batch, dropout_generator=gen,
                              pld_theta=torch.tensor(0.5))
        loss.backward()
        runs[policy] = (loss.detach(),
                        {n: p.grad for n, p in tmodel.named_parameters()})
    ref_loss, ref_grads = runs["full"]
    for policy, (loss, grads) in runs.items():
        assert torch.equal(loss, ref_loss), policy
        for name, g in ref_grads.items():
            assert torch.equal(grads[name], g), (policy, name)


@pytest.mark.parametrize("policy", POLICIES)
def test_block_sparse_forward_runs_again_under_every_policy(policy,
                                                            monkeypatch):
    """The block-sparse function's forward (B5 on a card; here its plain
    version) runs 2L times in a remat training step under every policy: no
    policy keeps its output, as no JAX policy names the Pallas kernel's
    (the recompute runs it again), and the backward runs once per layer."""
    *_, tmodel = _both("pallas", seed=5, dropout=RATE, remat=True,
                       remat_policy=policy, jax_over={"remat": False})
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = bsa.block_sparse_fwd, bsa.block_sparse_bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return real_bwd(*a, **k)

    monkeypatch.setattr(bsa, "block_sparse_fwd", fwd)
    monkeypatch.setattr(bsa, "block_sparse_bwd", bwd)
    bsa.launches_sparse_fwd = 0
    loss = tmodel.train()(**_torch_batch(_batch(seed=8)),
                          dropout_generator=torch.Generator().manual_seed(1))
    assert calls == {"fwd": L, "bwd": 0}
    loss.backward()
    assert calls == {"fwd": 2 * L, "bwd": L}
    assert bsa.launches_sparse_fwd == 0, "a CPU tensor is not a launch"


SMALL_DS = dict(train_micro_batch_size_per_gpu=2, gradient_clipping=1.0,
                optimizer=dict(type="FusedAdam", params=dict(lr=1e-3)),
                tpu=dict(use_pallas_optimizer=True))


def _engine(seed=0, config=None, **over):
    import deepspeed_tpu_torch

    cfg = tbert.BertConfig(**TINY, dtype=torch.float32, remat=True, **over)
    return deepspeed_tpu_torch.initialize(
        model=tbert.BertForPreTraining(cfg), config=config or SMALL_DS,
        device="cpu", seed=seed)[0]


def test_engine_gives_bert_its_generator_and_theta(tmp_path):
    """A dropout or stochastic-mode BERT gets the engine's dropout
    generator, and ``pld_theta`` follows the host schedule; the generator's
    state and the step counter go into a tag and come back: a resumed
    engine's next losses equal those of the engine that saved, bit for
    bit. Another generator state draws other masks."""
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    pld = {"enabled": True, "theta": 0.5, "gamma": 0.1}
    ds = dict(SMALL_DS, progressive_layer_drop=pld)
    batch = {k: v for k, v in _batch(seed=9).items()
             if k != "token_type_ids"}
    assert _engine()._dropout_gen is None
    assert _engine(dropout=RATE)._dropout_gen is not None
    assert _engine(dropout=RATE, config=ds).pld_theta() is None
    a = _engine(dropout=RATE, stochastic_mode=True, config=ds)
    assert a._dropout_gen is not None
    it = iter(RepeatingLoader([batch]))
    reference = JaxPLD(pld["theta"], pld["gamma"])
    first = []
    for step in range(3):
        assert math.isclose(float(a.pld_theta()), reference.get_theta(),
                            rel_tol=1e-6)
        first.append(float(a.train_batch(it)))
        reference.update_state(step + 1)
    a.save_checkpoint(str(tmp_path))
    want = [float(a.train_batch(it)) for _ in range(3)]
    b = _engine(seed=1, dropout=RATE, stochastic_mode=True, config=ds)
    b.load_checkpoint(str(tmp_path))
    assert math.isclose(float(b.pld_theta()),
                        JaxPLD(0.5, 0.1).update_state(3), rel_tol=1e-6)
    got = [float(b.train_batch(iter(RepeatingLoader([batch]))))
           for _ in range(3)]
    assert got == want
    c = _engine(dropout=RATE, stochastic_mode=True, config=ds)
    c._dropout_gen.manual_seed(1234)
    assert float(c.train_batch(iter(RepeatingLoader([batch])))) != first[0]


@pytest.mark.parametrize("mlm_bias", [False, True])
@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unscanned"])
def test_bert_exchange_layout_is_the_flax_flatten(scan, mlm_bias):
    """``bert_exchange_layout`` lays the port's parameters out as
    ``jax.tree.flatten`` lays out the flax BERT tree: the same leaf paths
    in the same order, and a flat buffer written through the layout's
    views equal to the concatenated flax leaves bit for bit."""
    jcfg = jbert.BertConfig(**dict(TINY, num_hidden_layers=3),
                            dtype=jnp.float32, scan_layers=scan,
                            use_mlm_bias=mlm_bias)
    params = jax.device_get(jbert.BertForPreTraining(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda x: rng.randn(*x.shape).astype(np.float32), params)
    if mlm_bias:
        params["mlm_bias"] = rng.randn(TINY["vocab_size"]).astype(np.float32)
    tcfg = tbert.BertConfig(**dict(TINY, num_hidden_layers=3),
                            dtype=torch.float32, scan_layers=scan,
                            use_mlm_bias=mlm_bias)
    model = tbert.BertForPreTraining(tcfg)
    model.load_state_dict(bert_state_dict_from_jax(params, tcfg), assign=True)
    named = list(model.named_parameters())
    layout = bert_exchange_layout([(n, p.shape) for n, p in named], tcfg)
    flat = flatten_jax_tree(params)
    assert [path for path, _ in layout.leaves] == [p for p, _ in flat]
    assert [s for _, s in layout.leaves] == [tuple(np.shape(a))
                                             for _, a in flat]
    buf = torch.zeros(layout.numel)
    for i, (_, p) in enumerate(named):
        layout.view(buf, i).copy_(p.detach())
    want = np.concatenate([np.asarray(a).reshape(-1) for _, a in flat])
    assert np.array_equal(buf.numpy(), want)
