"""The port's BERT against the flax model.

The flax ``BertForPreTraining`` is initialized from a seed; its parameter
tree (scanned or unscanned) is carried into the port by
``bert_state_dict_from_jax``. Both see the same numpy ids, masks and labels
(the tiny BERT of ``tests/unit/test_sparse_attention.py``, two layers), in
f32: logits agree to the order of sums (atol 1e-4 on logits of order 1,
loss 1e-5 relative), for full attention and for each of the three sparse
implementations. Gradients come back through the same mapping and are
held to 1e-5 absolute plus 1e-4 relative.
"""

import dataclasses
import os
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import bert as jbert
from deepspeed_tpu.ops.sparse_attention import sparse_attention_utils as jutils
from deepspeed_tpu_torch.models import bert as tbert
from deepspeed_tpu_torch.module_inject.jax_params import bert_state_dict_from_jax
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention_utils as tutils

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64)
T = 64
BIGBIRD = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
           "num_sliding_window_blocks": 3, "num_global_blocks": 1}


def _configs(kernel=None, scan=True, **over):
    """(flax config, port config), with the sparse block of ``kernel``
    ("gather", "pallas", "dense") or full attention (None)."""
    jcfg = jbert.BertConfig(**TINY, dtype=jnp.float32, param_dtype=jnp.float32,
                            scan_layers=scan, **over)
    tcfg = tbert.BertConfig(**TINY, dtype=torch.float32, scan_layers=scan, **over)
    if kernel is not None:
        block = dict(BIGBIRD, kernel=kernel)
        jcfg = dataclasses.replace(jcfg, sparse_attention=jutils.get_sparse_attention_config(
            dict(block), TINY["num_attention_heads"]))
        tcfg = dataclasses.replace(tcfg, sparse_attention=tutils.get_sparse_attention_config(
            dict(block), TINY["num_attention_heads"]))
    return jcfg, tcfg


def _batch(seed=0, b=2, masked=False):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], size=(b, T)).astype(np.int32)
    labels = np.where(rng.rand(b, T) < 0.15, ids, -100).astype(np.int32)
    labels[:, 0] = ids[:, 0]                 # at least one label per row
    out = {"input_ids": ids, "labels": labels,
           "token_type_ids": (rng.rand(b, T) < 0.5).astype(np.int32)}
    if masked:
        mask = np.ones((b, T), np.int32)
        mask[1, T - 11:] = 0
        out["attention_mask"] = mask
    return out


def _both(jcfg, tcfg, seed=0):
    jmodel = jbert.BertForPreTraining(jcfg)
    params = cached_init(jmodel, seed, jnp.zeros((1, T), jnp.int32))["params"]
    params = jax.device_get(params)
    tmodel = tbert.BertForPreTraining(tcfg)
    tmodel.load_state_dict(bert_state_dict_from_jax(params, tcfg), assign=True)
    return jmodel, params, tmodel


def _jax_call(jmodel, params, batch, **kw):
    return jmodel.apply({"params": params}, **{k: jnp.asarray(v) for k, v in batch.items()},
                        **kw)


def _torch_call(tmodel, batch, **kw):
    return tmodel(**{k: torch.tensor(v).long() for k, v in batch.items()}, **kw)


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "unscanned"])
@pytest.mark.parametrize("kernel", [None, "gather", "pallas", "dense"])
def test_logits_and_loss_match_flax(kernel, scan):
    jcfg, tcfg = _configs(kernel, scan=scan)
    jmodel, params, tmodel = _both(jcfg, tcfg)
    batch = _batch()
    no_labels = {k: v for k, v in batch.items() if k != "labels"}
    bsa.launches_sparse_fwd = 0
    with torch.no_grad():
        got = _torch_call(tmodel, no_labels)
        loss = _torch_call(tmodel, batch)
    assert got.dtype == torch.float32 and got.shape == (2, T, TINY["vocab_size"])
    np.testing.assert_allclose(got.numpy(), np.asarray(_jax_call(jmodel, params, no_labels)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(loss), float(_jax_call(jmodel, params, batch)),
                               rtol=1e-5)
    assert bsa.launches_sparse_fwd == 0


@pytest.mark.parametrize("kernel", [None, "gather", "pallas"])
def test_attention_mask_matches_flax(kernel):
    """A padded row: the einsum path masks keys, the sparse paths turn the
    mask into an additive key-padding mask; "pallas" with a mask warns and
    takes the dense path, as the JAX module does."""
    jcfg, tcfg = _configs(kernel)
    jmodel, params, tmodel = _both(jcfg, tcfg, seed=1)
    batch = _batch(seed=2, masked=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.no_grad():
            loss = _torch_call(tmodel, batch)
    dense_warned = any("DENSE" in str(w.message) for w in caught)
    assert dense_warned == (kernel == "pallas")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _jax_call(jmodel, params, batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)


@pytest.mark.parametrize("kernel", [None, "pallas", "gather"])
def test_gradients_match_jax(kernel):
    """jax.grad of the MLM loss, carried through bert_state_dict_from_jax,
    against the port's param.grad (through the plain B5-B7 path for
    "pallas"), with full remat on both sides."""
    jcfg, tcfg = _configs(kernel, remat=True)
    jmodel, params, tmodel = _both(jcfg, tcfg, seed=3)
    batch = _batch(seed=4)

    def loss_fn(p):
        return _jax_call(jmodel, p, batch)

    want = bert_state_dict_from_jax(jax.device_get(jax.grad(loss_fn)(params)), tcfg)
    tmodel.train()
    for p in tmodel.parameters():
        p.requires_grad_(True)
    _torch_call(tmodel, batch).backward()
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        torch.testing.assert_close(got[name], w, rtol=1e-4, atol=1e-5, msg=name)


def test_mlm_bias_and_state_dict_names():
    jcfg, tcfg = _configs(None, scan=False, use_mlm_bias=True)
    jmodel, params, tmodel = _both(jcfg, tcfg, seed=5)
    params = jax.tree_util.tree_map(np.array, params)
    params["mlm_bias"] = np.random.RandomState(6).randn(TINY["vocab_size"]).astype(np.float32)
    tmodel = tbert.BertForPreTraining(tcfg)
    sd = bert_state_dict_from_jax(params, tcfg)
    assert set(sd) == set(tmodel.state_dict())
    tmodel.load_state_dict(sd, assign=True)
    batch = _batch(seed=7)
    with torch.no_grad():
        got = _torch_call(tmodel, batch)
    np.testing.assert_allclose(float(got), float(_jax_call(jmodel, params, batch)), rtol=1e-5)


def test_bert_large_shapes_and_sizes():
    """bert_config gives the JAX package's sizes; the model is described on
    the meta device with the flax parameter count."""
    for name in tbert.BERT_SIZES:
        t, j = tbert.bert_config(name), jbert.bert_config(name)
        for f in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                  "intermediate_size", "vocab_size", "layer_norm_eps"):
            assert getattr(t, f) == getattr(j, f), (name, f)
    cfg = tbert.bert_config("bert-large", max_position_embeddings=4096)
    model = tbert.BertForPreTraining(cfg)
    assert all(p.is_meta for p in model.parameters())
    shapes = jax.eval_shape(
        lambda: jbert.BertForPreTraining(jbert.bert_config(
            "bert-large", max_position_embeddings=4096)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == want
    assert cfg.head_dim == 64


@pytest.mark.parametrize("field,value", [("stochastic_mode", True),
                                         ("remat_policy", "selective"),
                                         ("dropout", 0.1)])
def test_once_refused_fields_run(field, value):
    """The fields the port once refused build and train
    (``test_torch_bert_options.py`` holds them to JAX): in training mode
    the loss is finite and every parameter gets a finite gradient; eval
    mode, where dropout and stochastic depth are inert, gives the loss of
    the model without the field."""
    jcfg, tcfg = _configs(None, remat=True, **{field: value})
    _, params, tmodel = _both(_configs(None)[0], tcfg)
    _, _, plain = _both(_configs(None)[0], _configs(None)[1])
    batch = _batch()
    for p in tmodel.parameters():
        p.requires_grad_(True)
    loss = _torch_call(tmodel.train(), batch,
                       dropout_generator=torch.Generator().manual_seed(0),
                       pld_theta=torch.tensor(0.5))
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in tmodel.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    with torch.no_grad():
        got = _torch_call(tmodel.eval(), batch, pld_theta=torch.tensor(0.5))
        want = _torch_call(plain.eval(), batch)
    assert torch.equal(got, want)
