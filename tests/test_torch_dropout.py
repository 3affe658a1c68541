"""Dropout in training, against the JAX package.

The port draws its masks from a ``torch.Generator`` (the engine's), JAX from
its ``dropout`` key: the draws differ by design, so the model is held to JAX
where the masks do not matter (eval mode; rate 0 in training) and, with the
same masks handed to both (JAX's ``jax.random.bernoulli`` replaced by the
port's draws, site for site), on the einsum path in training. The routing
gate (flash and chunked attention have no probability dropout), the keep
share and the ``1 / (1 - p)`` scale, and the recompute (remat on = off from
one generator state) are the port's own.
"""

import importlib
import math
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
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

# the modules (the pallas package exports a function of the same name)
jflash = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")
jchunk = importlib.import_module("deepspeed_tpu.ops.chunked_attention")

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=256, n_embd=64, n_layer=2, n_head=2)
RATE = 0.1


def _ids(b, t, seed=0):
    return np.random.RandomState(seed).randint(
        0, SMALL["vocab_size"], size=(b, t)).astype(np.int32)


def _pair(rate=RATE, scan_layers=False, **over):
    jcfg = jlm.GPTConfig(**SMALL, dropout=rate, scan_layers=scan_layers,
                         dtype=jnp.float32, **over)
    jmodel = jlm.GPT(jcfg)
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    tcfg = tlm.GPTConfig(**SMALL, dropout=rate, scan_layers=scan_layers,
                         dtype=torch.float32, **over)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(gpt_state_dict_from_jax(jax.device_get(params),
                                                   tcfg), assign=True)
    for p in tmodel.parameters():
        p.requires_grad_(True)
    return jmodel, params, tmodel


def _assert_grads(tmodel, jg, rel=1e-5):
    want = gpt_state_dict_from_jax(jax.device_get(jg), tmodel.config)
    for name, p in tmodel.named_parameters():
        scale = float(want[name].abs().max())
        err = float((p.grad - want[name]).abs().max())
        assert err <= rel * scale + 1e-9, f"{name}: {err} of {scale}"


@pytest.mark.parametrize("flash", [False, True])
def test_eval_mode_ignores_dropout_as_jax_does(flash):
    """Eval mode: the logits of JAX's deterministic apply (atol 1e-4, the
    f32 bound of test_torch_transformer_lm.py)."""
    jmodel, params, tmodel = _pair(use_flash_attention=flash)
    ids = _ids(2, 128)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(ids),
                                   deterministic=True))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("flash", [False, True])
def test_rate_zero_trains_as_jax(flash):
    """Training mode at rate 0 draws nothing: loss and every gradient of
    JAX's non-deterministic apply (1e-5 of each gradient's largest)."""
    jmodel, params, tmodel = _pair(rate=0.0, use_flash_attention=flash,
                                   remat=True)
    ids = _ids(2, 128, seed=1)
    jl, jg = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids),
        deterministic=False, rngs={"dropout": jax.random.PRNGKey(1)}))(params)
    t = torch.from_numpy(ids).long()
    tl = tmodel.train()(t, labels=t)
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    _assert_grads(tmodel, jg)


def test_given_masks_training_matches_jax(monkeypatch):
    """The same masks on both sides (the port's draws, in its order, handed
    to JAX's ``bernoulli`` at each site: the embedding, then per layer the
    probabilities, the attention output and the MLP output): loss and every
    gradient of JAX's training apply, 1e-5 of each gradient's largest."""
    jmodel, params, tmodel = _pair()
    ids = _ids(2, 64, seed=2)
    gen = torch.Generator().manual_seed(5)
    masks = []
    real_draw = ac.bernoulli_mask

    def recording(shape, p, generator, device):
        m = real_draw(shape, p, generator, device)
        masks.append((tuple(shape), p, m.numpy().copy()))
        return m

    monkeypatch.setattr(ac, "bernoulli_mask", recording)
    t = torch.from_numpy(ids).long()
    tl = tmodel.train()(t, labels=t, dropout_generator=gen)
    tl.backward()
    assert len(masks) == 1 + 3 * SMALL["n_layer"]

    handed = iter(masks)

    def given(key, p=0.5, shape=None):
        want_shape, want_p, m = next(handed)
        assert tuple(shape) == want_shape
        assert math.isclose(float(p), want_p)
        return jnp.asarray(m)

    monkeypatch.setattr(jax.random, "bernoulli", given)
    jl, jg = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids),
        deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)}))(params)
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    _assert_grads(tmodel, jg)


def test_dropout_module_is_inverted_dropout():
    """``where(mask, x / keep, 0)``: every output is 0 or x / 0.9, the kept
    share within 6 binomial standard deviations of 0.9, and the mean of the
    output within the same bound of the input's; rate 1 gives zeros."""
    drop = tlm.Dropout(RATE).train()
    x = torch.ones(256, 1024)
    gen = torch.Generator().manual_seed(0)
    y = drop(x, gen)
    kept = y != 0
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.9))
    n = x.numel()
    share = float(kept.float().mean())
    assert abs(share - 0.9) <= 6 * math.sqrt(0.9 * 0.1 / n)
    assert abs(float(y.mean()) - 1.0) <= 6 * math.sqrt(0.1 / 0.9 / n)
    assert torch.equal(tlm.Dropout(1.0).train()(x, gen), torch.zeros_like(x))
    assert drop.eval()(x, gen) is x


def test_plain_recomputation_of_the_einsum_path():
    """The einsum path with a dropout against a plain re-computation of
    attention on the masks it drew: softmax(q k^T / sqrt(D) + causal) in
    f32, then where(mask, p / keep, 0), then @ v."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.tensor(rng.randn(2, 32, 2, 16).astype(np.float32))
               for _ in range(3))
    drop = tlm.Dropout(RATE).train()
    got = tlm.einsum_attention(q, k, v, causal=True, dropout=drop,
                               generator=torch.Generator().manual_seed(4))
    mask = ac.bernoulli_mask((2, 2, 32, 32), 0.9,
                             torch.Generator().manual_seed(4), "cpu")
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / 4.0
    s = s.masked_fill(~torch.ones(32, 32, dtype=torch.bool).tril(),
                      torch.finfo(torch.float32).min)
    p = torch.where(mask, torch.softmax(s, -1) / 0.9, 0.0)
    want = torch.einsum("bhqk,bkhd->bqhd", p, v)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("over", [dict(use_flash_attention=True),
                                  dict(attention_chunk=32),
                                  dict(use_flash_attention="auto")])
def test_training_dropout_takes_the_einsum_path_as_jax(over, monkeypatch):
    """JAX's gate (``dropout == 0 or deterministic``): under training
    dropout neither package reaches its flash or chunked attention; in eval
    mode (deterministic) both do, for the same configs."""
    if over.get("use_flash_attention") == "auto":
        # both selectors at one set of constants, flash from T 64
        for mod in (jlm, tlm):
            monkeypatch.setattr(mod, "FLASH_AUTO_MIN_SEQ", 64)
            monkeypatch.setattr(mod, "FLASH_MAX_SEQ", 8192)
    jmodel, params, tmodel = _pair(**over)
    jlm_calls, t_calls = [], []

    def record(name):
        def fn(*args, **kwargs):
            jlm_calls.append(name)
            raise _Reached()
        return fn

    monkeypatch.setattr(jflash, "flash_attention", record("flash"))
    monkeypatch.setattr(jchunk, "chunked_attention", record("chunked"))
    real_fwd = fa.flash_attention_fwd
    monkeypatch.setattr(fa, "flash_attention_fwd", lambda *a, **k: (
        t_calls.append("flash"), real_fwd(*a, **k))[1])
    ids = _ids(1, 128)
    t = torch.from_numpy(ids).long()
    # training: einsum on both sides
    jmodel.apply({"params": params}, jnp.asarray(ids), deterministic=False,
                 rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        tmodel.train()(t, dropout_generator=torch.Generator().manual_seed(0))
    assert jlm_calls == [] and t_calls == []
    # eval: both leave the einsum path the same way
    with pytest.raises(_Reached):
        jmodel.apply({"params": params}, jnp.asarray(ids), deterministic=True)
    route = tlm.attention_route(tmodel.config, 128)[0]
    assert route == jlm_calls[0]
    with torch.no_grad():
        tmodel.eval()(t)
    assert (route == "flash") == bool(t_calls)


class _Reached(Exception):
    pass


@pytest.mark.parametrize("policy", ["full", "selective"])
def test_recompute_draws_the_forward_masks(policy):
    """From one generator state, remat on and off give the same loss and
    the same gradients bit for bit (the recompute gets the forward's masks
    back), and leave the generator in the same state."""
    ids = torch.from_numpy(_ids(2, 128, seed=6)).long()
    out = []
    for remat in (False, True):
        _, _, tmodel = _pair(remat=remat, remat_policy=policy)
        gen = torch.Generator().manual_seed(9)
        loss = tmodel.train()(ids, labels=ids, dropout_generator=gen)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in
                                    tmodel.named_parameters()},
                    gen.get_state()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][2], out[1][2])
    for name, g in out[0][1].items():
        assert torch.equal(out[1][1][name], g), name


def test_engine_dropout_generator_resumes_the_stream(tmp_path):
    """The engine's dropout generator is seeded from the config seed, saved
    in a tag and restored: a resumed engine's next losses equal those of
    the engine that saved, bit for bit."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

    ds = dict(train_micro_batch_size_per_gpu=2, gradient_clipping=1.0,
              optimizer=dict(type="FusedAdam", params=dict(lr=1e-3)),
              tpu=dict(use_pallas_optimizer=True))
    ids = _ids(2, 64, seed=7)
    batch = dict(input_ids=ids, labels=ids)

    def engine(seed):
        cfg = tlm.GPTConfig(**SMALL, dropout=RATE, remat=True,
                            dtype=torch.float32)
        return deepspeed_tpu_torch.initialize(
            model=tlm.GPT(cfg), config=ds, device="cpu", seed=seed)[0]

    a = engine(0)
    it = iter(RepeatingLoader([batch]))
    first = [float(a.train_batch(it)) for _ in range(3)]
    a.save_checkpoint(str(tmp_path))
    want = [float(a.train_batch(it)) for _ in range(3)]
    b = engine(1)
    b.load_checkpoint(str(tmp_path))
    got = [float(b.train_batch(iter(RepeatingLoader([batch]))))
           for _ in range(3)]
    assert got == want
    # another seed draws other masks from the same weights and batch
    c = engine(0)
    c._dropout_gen.manual_seed(1234)
    assert float(c.train_batch(iter(RepeatingLoader([batch])))) != first[0]
