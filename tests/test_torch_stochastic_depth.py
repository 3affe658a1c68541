"""Stochastic depth under progressive layer drop, against the JAX package.

The schedule (``runtime/progressive_layer_drop.py``) and the keep
probability (``pld_keep_probability``) against JAX's own; a block whose gate
is decided (JAX's ``pld_keep`` 0.0 and 1.0 draw False and True whatever the
key) against the port's block with that gate; the whole model at theta 1
(every layer kept) against JAX's training apply; and the engine's device
theta against its host schedule, through a resume.
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop as JaxPLD
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=256, n_embd=64, n_layer=3, n_head=2)


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], size=(b, t)).astype(np.int32)


@pytest.mark.parametrize("theta,gamma", [(0.5, 0.001), (0.2, 0.05), (1.0, 0.1)])
def test_schedule_matches_jax(theta, gamma):
    mine, ref = ProgressiveLayerDrop(theta, gamma), JaxPLD(theta, gamma)
    assert mine.get_theta() == ref.get_theta() == 1.0
    for step in (0, 1, 7, 100, 5000):
        assert mine.update_state(step) == ref.update_state(step)
        assert mine.get_state() == ref.get_state()


def test_keep_probability_matches_jax():
    for n_layer in (1, 4, 24):
        for theta in (1.0, 0.5, 0.13):
            for i in range(n_layer):
                assert math.isclose(tlm.pld_keep_probability(i, n_layer, theta),
                                    float(jlm.pld_keep_probability(
                                        i, n_layer, theta)), rel_tol=1e-6)
    # the traced forms: a layer counter and a theta array
    got = tlm.pld_keep_probability(torch.arange(8.0), 8, torch.tensor(0.3))
    want = jlm.pld_keep_probability(jnp.arange(8), 8, jnp.float32(0.3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def _pair(n_layer=SMALL["n_layer"], **over):
    small = dict(SMALL, n_layer=n_layer)
    jcfg = jlm.GPTConfig(**small, stochastic_mode=True, scan_layers=False,
                         dtype=jnp.float32, **over)
    jmodel = jlm.GPT(jcfg)
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    tcfg = tlm.GPTConfig(**small, stochastic_mode=True, scan_layers=False,
                         dtype=torch.float32, **over)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(gpt_state_dict_from_jax(jax.device_get(params),
                                                   tcfg), assign=True)
    for p in tmodel.parameters():
        p.requires_grad_(True)
    return jcfg, jmodel, params, tmodel


@pytest.mark.parametrize("keep", [0.0, 1.0])
def test_decided_gate_block_matches_jax(keep):
    """JAX's Block with pld_keep 0.0 (the gate is False: the block's input
    comes back) and 1.0 (True: the block's output) against the port's
    block with that gate, in training mode (1e-5 of the largest entry)."""
    jcfg, _, params, tmodel = _pair(n_layer=1)
    x = np.random.RandomState(1).randn(2, 16, SMALL["n_embd"]).astype(
        np.float32)
    (jy, jaux) = jlm.Block(jcfg).apply(
        {"params": params["h_0"]}, jnp.asarray(x), deterministic=False,
        pld_keep=keep, rngs={"dropout": jax.random.PRNGKey(3)})
    block = tmodel.h[0].train()
    y, aux = block(torch.tensor(x), gate=torch.tensor(bool(keep)))
    assert aux is None and float(jaux) == 0.0
    want = np.asarray(jy)
    if keep == 0.0:
        assert torch.equal(y, torch.tensor(x))
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("remat", [False, True])
def test_model_at_theta_one_trains_as_jax(remat):
    """At theta 1 every layer is kept: the loss and every gradient of JAX's
    training apply with pld_theta 1.0 (1e-5 of each gradient's largest)."""
    _, jmodel, params, tmodel = _pair(remat=remat)
    ids = _ids(2, 64, seed=2)
    jl, jg = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids),
        deterministic=False, pld_theta=1.0,
        rngs={"dropout": jax.random.PRNGKey(0)}))(params)
    t = torch.from_numpy(ids).long()
    tl = tmodel.train()(t, labels=t, pld_theta=torch.tensor(1.0),
                        dropout_generator=torch.Generator().manual_seed(0))
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = gpt_state_dict_from_jax(jax.device_get(jg), tmodel.config)
    for name, p in tmodel.named_parameters():
        scale = float(want[name].abs().max())
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-5 * scale + 1e-9, f"{name}: {err} of {scale}"


def test_dropped_layers_are_identities_and_recompute_reuses_gates():
    """At theta 0 (keep 1 - i/L) a dropped layer leaves the stream as it
    was; remat on and off draw the same gates and give the same loss and
    gradients from one generator state; eval mode runs every layer."""
    ids = torch.from_numpy(_ids(2, 64, seed=4)).long()
    out = []
    for remat in (False, True):
        *_, tmodel = _pair(n_layer=6, remat=remat)
        gen = torch.Generator().manual_seed(11)
        loss = tmodel.train()(ids, labels=ids, pld_theta=torch.tensor(0.0),
                              dropout_generator=gen)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    tmodel.named_parameters()}))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        assert torch.equal(out[1][1][name], g), name
    # the gates of that draw: a dropped layer's parameters get no gradient
    gates = torch.rand(6, generator=torch.Generator().manual_seed(11)) < (
        1 - torch.arange(6.0) / 6)
    assert not bool(gates.all()), "this seed should drop a layer"
    for i, kept in enumerate(gates.tolist()):
        g = out[0][1][f"h.{i}.mlp.c_fc.weight"]
        assert bool(g.abs().sum() > 0) == kept, i
    with torch.no_grad():
        a = tmodel.eval()(ids, labels=ids, pld_theta=torch.tensor(0.0))
        b = tmodel.eval()(ids, labels=ids)
    assert torch.equal(a, b)


def test_engine_theta_follows_the_host_schedule(tmp_path):
    """The engine computes pld_theta on the device from its step counter:
    at every step it equals the host schedule's theta, and a resume sets
    both from the tag's step (the captured step's counter in place)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    pld = {"enabled": True, "theta": 0.5, "gamma": 0.1}
    ds = dict(train_micro_batch_size_per_gpu=2,
              optimizer=dict(type="FusedAdam", params=dict(lr=1e-3)),
              tpu=dict(use_pallas_optimizer=True), progressive_layer_drop=pld)
    ids = _ids(2, 32, seed=5)
    batch = dict(input_ids=ids, labels=ids)

    def engine(seed=0, gas=1):
        cfg = tlm.GPTConfig(**SMALL, stochastic_mode=True, remat=True,
                            dtype=torch.float32)
        return deepspeed_tpu_torch.initialize(
            model=tlm.GPT(cfg), device="cpu", seed=seed,
            config=dict(ds, gradient_accumulation_steps=gas))[0]

    a = engine()
    it = iter(RepeatingLoader([batch]))
    reference = JaxPLD(pld["theta"], pld["gamma"])
    for step in range(4):
        assert math.isclose(float(a.pld_theta()), reference.get_theta(),
                            rel_tol=1e-6)
        assert a.progressive_layer_drop.get_theta() == reference.get_theta()
        a.train_batch(it)
        reference.update_state(step + 1)
    a.save_checkpoint(str(tmp_path))
    want = [float(a.train_batch(it)) for _ in range(2)]
    b = engine(seed=3)
    b.load_checkpoint(str(tmp_path))
    assert math.isclose(float(b.pld_theta()), JaxPLD(0.5, 0.1).update_state(4),
                        rel_tol=1e-6)
    got = [float(b.train_batch(iter(RepeatingLoader([batch]))))
           for _ in range(2)]
    assert got == want
    # gas 2: the counter moves once per optimizer step
    c = engine(gas=2)
    it = iter(RepeatingLoader([batch]))
    c.train_batch(it)
    assert float(c._pld_step) == 1.0 and c.global_steps == 1
