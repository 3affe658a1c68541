"""The port's LAMB, Adagrad and SGD, its lr write-through and its
wall-clock timers, against optax and the JAX package's engine.

The optimizers are held against ``optax.lamb`` / ``optax.adagrad`` /
``optax.sgd`` on the same f32 parameters and gradients for 3 steps, to
2e-6 absolute and relative (the same arithmetic in the same order; the
norms and ``rsqrt`` round differently), and through each engine on a small
f32 GPT from the same weights and batches: losses and grad norms to 1e-5
relative (``test_torch_engine.py``'s bound), parameters through their
updates (trained minus initial weights) to 1e-3 in relative L2 norm, with
the key third of ``c_attn.bias`` apart, to K * 2 * lr (see
``test_torch_checkpoint.py`` and ``test_torch_engine.py``). The JAX GPT
runs unscanned there, so that LAMB's per-leaf trust ratio sees one layer's
weight per leaf, as the port's per-parameter ratio does. An lr override is
an absolute lr in the port and a factor ``lr / scheduled_lr`` on the JAX
update, so parameters after an override agree to f32 rounding, within the
same bound.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.runtime import optimizer as topt
from deepspeed_tpu_torch.utils import timer as ttimer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=2)
K = 3
UPDATE_REL_L2 = 1e-3

FAMILIES = {
    "lamb": ({"type": "Lamb", "params": {"lr": 1e-2, "betas": [0.9, 0.95],
                                         "weight_decay": 0.1}},
             lambda: optax.lamb(1e-2, b1=0.9, b2=0.95, eps=1e-8,
                                weight_decay=0.1)),
    "adagrad": ({"type": "Adagrad", "params": {"lr": 1e-2}},
                lambda: optax.adagrad(1e-2, eps=1e-10)),
    "sgd_momentum_0": ({"type": "SGD", "params": {"lr": 1e-1}},
                       lambda: optax.sgd(1e-1, momentum=0.0)),
    "sgd_momentum_0.9": ({"type": "SGD", "params": {"lr": 1e-1,
                                                    "momentum": 0.9}},
                         lambda: optax.sgd(1e-1, momentum=0.9)),
    "sgd_nesterov": ({"type": "SGD", "params": {"lr": 1e-1, "momentum": 0.9,
                                                "nesterov": True}},
                     lambda: optax.sgd(1e-1, momentum=0.9, nesterov=True)),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_optimizer_matches_optax(family):
    """3 steps from the same parameters and gradients; one parameter is all
    zeros (LAMB's trust ratio is then 1; Adagrad's accumulator starts at
    0.1)."""
    block, make = FAMILIES[family]
    rng = np.random.RandomState(0)
    shapes = [(16, 8), (8,), (3, 4, 5), (6,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    params[-1][:] = 0.0
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(K)]
    tx = make()
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = topt.build_optimizer(tp, block["type"], block["params"])
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.tensor(x) for x in g])
    assert opt.count == K
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                                   atol=2e-6)


def _config(opt, **over):
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
          "optimizer": opt, "steps_per_print": 10 ** 9}
    ds.update(over)
    return ds


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, SMALL["vocab_size"], size=(n, 2, 32)).astype(np.int32)
    return [{"input_ids": x, "labels": x} for x in ids]


def _engines(ds):
    """The JAX engine (unscanned GPT, one device) and the port's, from the
    same weights; and the initial weights."""
    jmodel = jlm.GPT(jlm.GPTConfig(**SMALL, dtype=jnp.float32,
                                   scan_layers=False))
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    jeng, jopt, _, _ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=1, devices=jax.devices()[:1]))
    tcfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    start = gpt_state_dict_from_jax(jax.device_get(params), tcfg)
    teng, topt_, _, _ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tcfg), config=ds, device="cpu",
        model_parameters={k: v.clone() for k, v in start.items()})
    return jeng, jopt, teng, topt_, start


def _step_both(jeng, teng, batch):
    """One step of each engine, held to each other; the port's loss."""
    jl = float(jeng.train_batch(iter([batch])))
    tl = teng.train_batch(iter([batch]))
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               jeng.get_global_grad_norm(), rtol=1e-5)
    return tl


def _assert_params_close(jeng, teng, start, k, lr):
    want = gpt_state_dict_from_jax(jax.device_get(jeng.params),
                                   teng.module.config)
    got = teng.module.state_dict()
    C = SMALL["n_embd"]
    diff_sq = upd_sq = 0.0
    for name, w in want.items():
        g, s = got[name].float(), start[name]
        if name.endswith("attn.c_attn.bias"):
            torch.testing.assert_close(g[C:2 * C], w[C:2 * C], rtol=0,
                                       atol=k * 2 * lr, msg=name)
            g, w, s = (torch.cat([x[:C], x[2 * C:]]) for x in (g, w, s))
        diff_sq += float(((g - w) ** 2).sum())
        upd_sq += float(((w - s) ** 2).sum())
    assert (diff_sq / upd_sq) ** 0.5 <= UPDATE_REL_L2


def _group(opt):
    return {k: v for k, v in opt.param_groups[0].items() if k != "params"}


@pytest.mark.parametrize("family", ["lamb", "adagrad", "sgd_nesterov"])
def test_engine_matches_jax(family):
    """3 steps through each engine; ``param_groups`` carries the family's
    own keys only, with the JAX engine's values."""
    block, _ = FAMILIES[family]
    jeng, jopt, teng, topt_, start = _engines(_config(block))
    assert type(teng.optimizer).__name__ == {
        "lamb": "Lamb", "adagrad": "Adagrad", "sgd_nesterov": "SGD"}[family]
    assert _group(topt_) == _group(jopt)
    for batch in _batches(K):
        _step_both(jeng, teng, batch)
    assert teng.optimizer.count == K
    _assert_params_close(jeng, teng, start, K, block["params"]["lr"])


def test_param_groups_no_adam_defaults_for_sgd():
    """As the JAX test of the name: an SGD config reports no betas or
    eps, only its own keys."""
    engine, opt, _, _ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float32)),
        config=_config({"type": "SGD",
                        "params": {"lr": 1e-2, "momentum": 0.9}}),
        device="cpu")
    g = opt.param_groups[0]
    assert "betas" not in g and "eps" not in g, g
    assert g["momentum"] == pytest.approx(0.9)
    assert g["lr"] == pytest.approx(1e-2)
    assert len(g["params"]) == len(list(engine.module.parameters()))
    with pytest.raises(NotImplementedError, match="only 'lr'"):
        g["momentum"] = 0.5


def test_param_groups_lr_write_through():
    """SGD without a scheduler, in both engines: lr 0 through
    ``param_groups`` freezes the parameters (the port's exactly), the
    override persists, and lr 0.1 moves them again."""
    lr = 0.1
    jeng, jopt, teng, topt_, start = _engines(
        _config({"type": "SGD", "params": {"lr": lr}}))
    batches = _batches(3)
    _step_both(jeng, teng, batches[0])
    before = {k: v.clone() for k, v in teng.module.state_dict().items()}
    jopt.param_groups[0]["lr"] = 0.0
    topt_.param_groups[0]["lr"] = 0.0
    assert teng.get_lr() == jeng.get_lr() == [0.0]
    _step_both(jeng, teng, batches[1])
    for name, p in teng.module.state_dict().items():
        assert torch.equal(p, before[name]), name
    assert teng.get_lr() == [0.0]
    jopt.param_groups[0]["lr"] = lr
    topt_.param_groups[0]["lr"] = lr
    _step_both(jeng, teng, batches[2])
    assert not torch.equal(teng.module.state_dict()["wte.weight"],
                           before["wte.weight"])
    _assert_params_close(jeng, teng, start, 2, lr)


def test_lr_override_cleared_by_scheduler():
    """With a WarmupLR scheduler an override lasts one step in both
    engines: the step uses it, then the schedule's lr comes back."""
    ds = _config({"type": "AdamW", "params": {"lr": 1e-3}},
                 scheduler={"type": "WarmupLR", "params": {
                     "warmup_min_lr": 1e-4, "warmup_max_lr": 1e-3,
                     "warmup_num_steps": 10}})
    jeng, jopt, teng, topt_, start = _engines(ds)
    batches = _batches(3)
    _step_both(jeng, teng, batches[0])
    jopt.param_groups[0]["lr"] = 5e-2
    topt_.param_groups[0]["lr"] = 5e-2
    assert teng.get_lr() == jeng.get_lr() == [5e-2]
    _step_both(jeng, teng, batches[1])
    assert teng._lr_override is None and jeng._lr_override is None
    assert teng.get_lr() != [5e-2]
    np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)
    _step_both(jeng, teng, batches[2])
    _assert_params_close(jeng, teng, start, 3, 5e-2)


def test_wall_clock_breakdown_times_forward_and_step(monkeypatch):
    """``wall_clock_breakdown`` is accepted; as in the JAX engine, a gas-1
    ``train_batch`` then runs ``forward`` and ``step``, each timed, and
    each step logs both times. The losses are the JAX engine's under the
    same config, and the port's own fused step's, exactly."""
    logged = []
    monkeypatch.setattr(ttimer, "log_dist",
                        lambda msg, ranks=None: logged.append(msg))
    opt = {"type": "AdamW", "params": {"lr": 1e-3}}
    jeng, _, teng, _, start = _engines(_config(opt, wall_clock_breakdown=True))
    fused, *_ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float32)),
        config=_config(opt), device="cpu",
        model_parameters={k: v.clone() for k, v in start.items()})
    for batch in _batches(2):
        assert float(_step_both(jeng, teng, batch)) == float(
            fused.train_batch(iter([batch])))
    assert teng.global_steps == teng.micro_steps == 2
    times = [m for m in logged if m.startswith("time (ms)")]
    assert len(times) == 2
    for m in times:
        assert "fwd_bwd_microstep" in m and "step_microstep" in m
    for name, p in teng.module.state_dict().items():
        assert torch.equal(p, fused.module.state_dict()[name]), name


@pytest.mark.parametrize("bad", [None, np.inf, np.nan])
def test_check_overflow_matches_jax(bad):
    """``CheckOverflow`` over a list of gradients, as the JAX package's over
    the same arrays."""
    from deepspeed_tpu.runtime.utils import CheckOverflow as JaxCheckOverflow
    from deepspeed_tpu_torch.runtime.utils import CheckOverflow

    rng = np.random.RandomState(0)
    grads = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(np.float32)]
    if bad is not None:
        grads[1][2] = bad
    want = bool(JaxCheckOverflow()([jnp.asarray(g) for g in grads]))
    assert bool(CheckOverflow()([torch.tensor(g) for g in grads])) == want
    assert want == (bad is not None)
