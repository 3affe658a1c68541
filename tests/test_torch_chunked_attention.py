"""Chunked attention and the attention router against the JAX package.

``ops/chunked_attention.chunked_attention`` against
``deepspeed_tpu/ops/chunked_attention.py`` (forward and the gradients of
q, k, v on the same numpy inputs); the model with ``attention_chunk``
against JAX's; and the router: JAX's gate for the chunked and flash paths
(no mask, no segments, no ALiBi, no training dropout, divisibility), and
the ``use_flash_attention="auto"`` selector, with the port's constants set
to JAX's, routing every T of a grid as the JAX model routes it (its flash
and chunked functions replaced by recorders).
"""

import importlib
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
from deepspeed_tpu_torch.ops.chunked_attention import chunked_attention

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

# the modules (the pallas package exports a function of the same name)
jflash = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")
jchunk = importlib.import_module("deepspeed_tpu.ops.chunked_attention")

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=1024, n_embd=64, n_layer=2,
             n_head=2)


def _qkv(b, t, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,chunk", [(128, 32), (96, 96), (64, 16)])
def test_matches_jax_f32(causal, t, chunk):
    """The output and the gradients of q, k, v for one cotangent: 1e-5 of
    each one's largest entry (f32, the order of sums)."""
    q, k, v, g = _qkv(2, t, 2, 16, seed=t + causal)

    def jfn(q, k, v):
        o = jchunk.chunked_attention(q, k, v, causal=causal, chunk=chunk)
        return jnp.sum(o * jnp.asarray(g)), o

    (_, jo), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                         has_aux=True)(*map(jnp.asarray,
                                                            (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    to = chunked_attention(tq, tk, tv, causal=causal, chunk=chunk)
    (to * torch.tensor(g)).sum().backward()
    for got, want in ((to.detach(), jo), (tq.grad, jgrads[0]),
                      (tk.grad, jgrads[1]), (tv.grad, jgrads[2])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_bf16_tracks_jax():
    """bf16 inputs: the probabilities are cast to bf16 before the value
    product on both sides; output within 1e-2 relative L2 of JAX's."""
    q, k, v, _ = _qkv(1, 128, 2, 32, seed=5)
    jo = np.asarray(jchunk.chunked_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), chunk=32),
        np.float32)
    to = chunked_attention(*(torch.tensor(a).bfloat16() for a in (q, k, v)),
                           chunk=32)
    assert to.dtype == torch.bfloat16
    rel = np.linalg.norm(to.float().numpy() - jo) / np.linalg.norm(jo)
    assert rel < 1e-2, rel


def test_refuses_an_undivided_length():
    q = torch.zeros(1, 100, 1, 16)
    with pytest.raises(ValueError, match="not divisible"):
        chunked_attention(q, q, q, chunk=32)


def _pair(**over):
    jcfg = jlm.GPTConfig(**SMALL, dtype=jnp.float32, **over)
    jmodel = jlm.GPT(jcfg)
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    tcfg = tlm.GPTConfig(**SMALL, dtype=torch.float32, **over)
    tmodel = tlm.GPT(tcfg)
    tmodel.load_state_dict(gpt_state_dict_from_jax(jax.device_get(params),
                                                   tcfg), assign=True)
    for p in tmodel.parameters():
        p.requires_grad_(True)
    return jmodel, params, tmodel.train()


@pytest.mark.parametrize("remat", [False, True])
def test_model_with_attention_chunk_trains_as_jax(remat):
    """attention_chunk=32 at T 128 (the chunked path on both sides): loss
    and every gradient, 1e-5 of each gradient's largest."""
    jmodel, params, tmodel = _pair(attention_chunk=32, remat=remat)
    ids = np.random.RandomState(2).randint(0, SMALL["vocab_size"], (2, 128))
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


class _Reached(Exception):
    pass


def _jax_route(monkeypatch, jmodel, params, t, **call):
    """The path the JAX model takes for length ``t``: its flash and
    chunked functions raise on entry and say which (and at what chunk)."""
    def record(name):
        def fn(*args, **kwargs):
            raise _Reached(name, kwargs.get("chunk"))
        return fn

    monkeypatch.setattr(jflash, "flash_attention", record("flash"))
    monkeypatch.setattr(jchunk, "chunked_attention", record("chunked"))
    ids = jnp.zeros((1, t), jnp.int32)
    try:
        jmodel.apply({"params": params}, ids, **call)
    except _Reached as reached:
        return reached.args
    return ("einsum", None)


# the grid: lengths around every threshold of the selector below
GRID = (64, 96, 128, 192, 256, 320, 384, 512, 640, 768)


@pytest.mark.parametrize("flash", ["auto", True, False])
def test_auto_selector_routes_as_jax(flash, monkeypatch):
    """With both packages' constants at one scaled set (flash from 128,
    chunked past 256 at the largest of 512, 256, 128 dividing T, JAX's
    structure at 1/32 of its lengths), every T of the grid takes the same
    path in both."""
    for mod in (jlm, tlm):
        monkeypatch.setattr(mod, "FLASH_AUTO_MIN_SEQ", 128)
        monkeypatch.setattr(mod, "FLASH_MAX_SEQ", 256)
        monkeypatch.setattr(mod, "CHUNKED_AUTO_CHUNK", 512)
    jmodel, params, tmodel = _pair(use_flash_attention=flash)
    for t in GRID:
        want = _jax_route(monkeypatch, jmodel, params, t, deterministic=True)
        assert tlm.attention_route(tmodel.config, t) == want, t


def test_auto_selector_at_jax_constants():
    """The port's selector with JAX's own constants (512, 8192, 1024)
    against JAX's rule written out, over lengths up to 32768."""
    cfg = tlm.GPTConfig(use_flash_attention="auto")
    lengths = [64 * i for i in range(1, 64)] + [8192, 8320, 12288, 16384,
                                                16512, 24576, 32768]

    def jax_rule(t):
        if t > 8192:
            chunk = next((c for c in (1024, 512, 256, 128) if t % c == 0),
                         None)
            if chunk and t > chunk:
                return ("chunked", chunk)
        if 512 <= t <= 8192 and t % 128 == 0:
            return ("flash", None)
        return ("einsum", None)

    import unittest.mock as mock

    with mock.patch.multiple(tlm, FLASH_AUTO_MIN_SEQ=512, FLASH_MAX_SEQ=8192,
                             CHUNKED_AUTO_CHUNK=1024):
        for t in lengths:
            assert tlm.attention_route(cfg, t) == jax_rule(t), t


@pytest.mark.parametrize("over,call,want", [
    (dict(attention_chunk=32), {}, ("chunked", 32)),
    (dict(attention_chunk=32, use_flash_attention=True), {}, ("chunked", 32)),
    (dict(attention_chunk=128), {}, ("einsum", None)),     # T == chunk
    (dict(attention_chunk=48), {}, ("einsum", None)),      # 128 % 48
    (dict(attention_chunk=48, use_flash_attention=True), {}, ("flash", None)),
    (dict(attention_chunk=32), dict(mask=True), ("einsum", None)),
    (dict(attention_chunk=32, use_flash_attention=True),
     dict(segments=True), ("flash", None)),
    (dict(attention_chunk=32, alibi=True, learned_positions=False), {},
     ("einsum", None)),
])
def test_router_gate_is_jax_gate(over, call, want, monkeypatch):
    """JAX's gate at T 128: an explicit chunk wins over flash; a mask,
    segments, ALiBi, T == chunk or an undivided T keep it off the chunked
    path; flash still takes segments but not a mask or ALiBi."""
    jmodel, params, tmodel = _pair(**over)
    jcall = dict(deterministic=True)
    if call.get("mask"):
        jcall["attention_mask"] = jnp.ones((1, 128), jnp.int32)
    if call.get("segments"):
        jcall["segment_ids"] = jnp.ones((1, 128), jnp.int32)
    got = tlm.attention_route(tmodel.config, 128, **call)
    assert got == want
    assert _jax_route(monkeypatch, jmodel, params, 128, **jcall) == want
