"""The fused LM head + cross entropy against the JAX package.

``ops/cross_entropy.fused_linear_cross_entropy`` against
``deepspeed_tpu/ops/cross_entropy.py``'s on the same numpy inputs, as
``tests/unit/test_ops.py:158-230`` holds the JAX one (both layouts, a bias,
bf16, a token count that is padded up to the chunk); the model's loss and
gradients under ``fused_head_ce`` 2048, True and a small chunk against
JAX's; and the ``"auto"`` decision against JAX's formula.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.ops import cross_entropy as jce
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.ops import cross_entropy as tce

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=256, n_embd=64, n_layer=2, n_head=2)


def _setup(vocab_major, dt, n=96, e=32, v=257, seed=0):
    """test_ops.py's inputs: x [n, e], w [v, e] or [e, v], bias [v],
    targets, 0/1 weights (about 80% ones)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, e).astype(dt)
    w = (rng.randn(*((v, e) if vocab_major else (e, v))) * 0.05).astype(dt)
    b = (rng.randn(v) * 0.1).astype(dt)
    t = rng.randint(0, v, n)
    wt = (rng.rand(n) > 0.2).astype(np.float32)
    return x, w, b, t, wt


def _jax(vocab_major, chunk, x, w, b, t, wt, dtype=jnp.float32):
    args = [jnp.asarray(a, dtype) for a in (x, w)]
    argnums = (0, 1)
    if b is not None:
        args.append(jnp.asarray(b, dtype))
        argnums = (0, 1, 2)

    def loss(*a):
        bias = a[2] if b is not None else None
        return jce.fused_linear_cross_entropy(
            vocab_major, chunk, a[0], a[1], bias, jnp.asarray(t),
            jnp.asarray(wt))

    val, grads = jax.value_and_grad(loss, argnums=argnums)(*args)
    return float(val), [np.asarray(g, np.float32) for g in grads]


def _torch(vocab_major, chunk, x, w, b, t, wt, dtype=torch.float32):
    leaves = [torch.tensor(a).to(dtype).requires_grad_() for a in (x, w)]
    if b is not None:
        leaves.append(torch.tensor(b).to(dtype).requires_grad_())
    loss = tce.fused_linear_cross_entropy(
        vocab_major, chunk, leaves[0], leaves[1],
        leaves[2] if b is not None else None, torch.tensor(t),
        torch.tensor(wt))
    loss.backward()
    for leaf in leaves:
        assert leaf.grad.dtype == dtype
    return float(loss), [leaf.grad.float().numpy() for leaf in leaves]


@pytest.mark.parametrize("vocab_major", [False, True])
@pytest.mark.parametrize("chunk", [24, 96, 2048])
def test_matches_jax_f32(vocab_major, chunk):
    """f32, with a bias: the loss to 1e-6 relative, the gradients to 1e-5
    of each one's largest entry."""
    inputs = _setup(vocab_major, np.float32)
    jl, jg = _jax(vocab_major, chunk, *inputs)
    tl, tg = _torch(vocab_major, chunk, *inputs)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_padded_token_count_matches_jax():
    """53 tokens in chunks of 16: padded to 64 with zero-weight dummies on
    both sides; the same loss and gradients as the unpadded JAX call."""
    inputs = _setup(False, np.float32, n=53)
    jl, jg = _jax(False, 16, *inputs)
    tl, tg = _torch(False, 16, *inputs)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert tg[0].shape == (53, 32)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_bf16_without_bias_tracks_jax():
    """bf16 operands, no bias: the gradients come back in bf16; both sides
    round the logits and the cotangent to bf16 at the same points, the
    products accumulate in f32: the loss within 2e-3 relative, the
    gradients within 1e-2 relative L2 of JAX's."""
    x, w, _, t, wt = _setup(True, np.float32)
    jl, jg = _jax(True, 32, x, w, None, t, wt, dtype=jnp.bfloat16)
    tl, tg = _torch(True, 32, x, w, None, t, wt, dtype=torch.bfloat16)
    assert abs(tl - jl) <= 2e-3 * abs(jl)
    for got, want in zip(tg, jg):
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-2, rel


def test_matches_the_unfused_loss():
    """The fused op against the port's own unfused head: the logits, then
    softmax_cross_entropy (f32, 1e-6 / 1e-5 of the largest entry)."""
    x, w, b, t, wt = (torch.tensor(a) for a in _setup(True, np.float32))
    xs, ws, bs = (a.clone().requires_grad_() for a in (x, w, b))
    ref = tce.softmax_cross_entropy(xs @ ws.t() + bs, t, wt)
    ref.backward()
    xf, wf, bf = (a.clone().requires_grad_() for a in (x, w, b))
    got = tce.fused_linear_cross_entropy(True, 40, xf, wf, bf, t, wt)
    got.backward()
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
    for a, r in ((xf, xs), (wf, ws), (bf, bs)):
        torch.testing.assert_close(a.grad, r.grad, rtol=0,
                                   atol=1e-5 * float(r.grad.abs().max()))


def _pair(fused, tied=True):
    over = {} if tied else dict(tie_word_embeddings=False, lm_head_bias=True)
    jcfg = jlm.GPTConfig(**SMALL, fused_head_ce=fused, dtype=jnp.float32,
                         **over)
    jmodel = jlm.GPT(jcfg)
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    if not tied:
        # a bias that is not zero, so its gradient path is exercised
        params = jax.tree_util.tree_map(lambda x: x, params)
        params["lm_head_bias"] = jnp.asarray(
            np.random.RandomState(9).randn(SMALL["vocab_size"]) * 0.1,
            jnp.float32)
    tcfg = tlm.GPTConfig(**SMALL, fused_head_ce=fused, dtype=torch.float32,
                         **over)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(gpt_state_dict_from_jax(jax.device_get(params),
                                                   tcfg), assign=True)
    for p in tmodel.parameters():
        p.requires_grad_(True)
    return jmodel, params, tmodel.train()


@pytest.mark.parametrize("fused,tied", [(2048, True), (True, True),
                                        (48, True), (48, False)])
def test_model_fused_head_matches_jax(fused, tied):
    """The model's loss and every gradient with the fused head (2048, True,
    and a chunk of 48 that pads 2 x 60 tokens to 144) against JAX's, tied
    and untied with a head bias (1e-5 of each gradient's largest)."""
    jmodel, params, tmodel = _pair(fused, tied)
    ids = np.random.RandomState(1).randint(0, SMALL["vocab_size"], (2, 60))
    jl, jg = jax.value_and_grad(lambda p: jmodel.apply(
        {"params": p}, jnp.asarray(ids), labels=jnp.asarray(ids),
        deterministic=False))(params)
    t = torch.from_numpy(ids).long()
    tl = tmodel(t, labels=t)
    tl.backward()
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = gpt_state_dict_from_jax(jax.device_get(jg), tmodel.config)
    for name, p in tmodel.named_parameters():
        scale = float(want[name].abs().max())
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-5 * scale + 1e-9, f"{name}: {err} of {scale}"


def test_model_routes_through_the_fused_op(monkeypatch):
    """fused_head_ce True reaches fused_linear_cross_entropy with JAX's
    chunk (2048) and the tied [V, E] layout; False and 0 never do."""
    seen = []
    real = tce.fused_linear_cross_entropy

    def spy(vocab_major, chunk, *args):
        seen.append((vocab_major, chunk))
        return real(vocab_major, chunk, *args)

    monkeypatch.setattr(tce, "fused_linear_cross_entropy", spy)
    ids = torch.zeros((1, 16), dtype=torch.long)
    for fused in (True, False, 0):
        *_, tmodel = _pair(fused)
        tmodel(ids, labels=ids)
    assert seen == [(True, 2048)]


@pytest.mark.parametrize("batch,seq,vocab,dtype", [
    (1, 2048, 2 ** 20, "bfloat16"), (1, 2048, 2 ** 19, "bfloat16"),
    (6, 2048, 250880, "bfloat16"), (4, 2048, 250880, "bfloat16"),
    (2, 4096, 256000, "bfloat16"), (4, 1024, 50257, "float32"),
    (8, 4096, 32000, "float32"), (16, 2048, 65536, "float16")])
def test_auto_decision_is_jax_formula(batch, seq, vocab, dtype):
    """"auto" engages at B*T*V*itemsize >= 4 GiB of compute-dtype logits,
    JAX's formula (transformer_lm.py:1196-1198) with its dtype's itemsize;
    True means 2048, an int its chunk, False and 0 nothing (bool first)."""
    jdt = jnp.dtype(dtype)
    want = batch * seq * vocab * jdt.itemsize >= (4 << 30)
    cfg = tlm.GPTConfig(vocab_size=vocab, dtype=getattr(torch, dtype))
    got = tlm.fused_head_engages(cfg, batch, seq)
    assert got == (2048 if want else 0)
    for value, chunk in ((True, 2048), (False, 0), (0, 0), (512, 512)):
        import dataclasses

        assert tlm.fused_head_engages(
            dataclasses.replace(cfg, fused_head_ce=value), batch, seq) == chunk


def test_bad_fused_head_values_raise():
    for value in ("yes", -1, 1.5):
        with pytest.raises(ValueError, match="fused_head_ce"):
            tlm.GPTConfig(fused_head_ce=value)
