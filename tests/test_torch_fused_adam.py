"""The port's AdamW updates against the JAX package's.

``fused_adamw_update`` on CPU tensors runs ``fused_adamw_reference``, the
plain version of the B4 kernel; the JAX side runs the Pallas kernel in
interpret mode. The plain ``AdamW`` is held against ``optax.adamw`` (and
``adam`` with coupled decay), including bf16 moments. Inputs come from numpy
with a seed and reach both sides as the same values.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepspeed_tpu.ops.pallas.fused_adam import fused_adamw
from deepspeed_tpu.ops.pallas.fused_adam import \
    fused_adamw_update as jax_fused_adamw_update
from deepspeed_tpu.runtime import lr_schedules as jax_lr_schedules
from deepspeed_tpu_torch.ops.cuda import fused_adam as fadam
from deepspeed_tpu_torch.runtime import lr_schedules
from deepspeed_tpu_torch.runtime.optimizer import AdamW, build_optimizer

torch.set_num_threads(2)

SHAPES = [(33, 17), (128,), (5, 4, 3), (1000,)]
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8)
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _arrays(seed, dtype):
    """Per-shape params, and grads for ``steps`` steps, as numpy f32 values
    that ``dtype`` holds exactly."""
    rng = np.random.RandomState(seed)
    exact = lambda x: torch.from_numpy(x.astype(np.float32)).to(dtype).float().numpy()  # noqa: E731
    params = [exact(rng.randn(*s)) for s in SHAPES]
    grads = [[exact(rng.randn(*s) * 0.1) for s in SHAPES] for _ in range(3)]
    return params, grads


def _to_torch(xs, dtype):
    # copies: the port updates in place, and jax may share numpy's memory
    return [torch.tensor(x).to(dtype) for x in xs]


def _to_jax(xs, dtype):
    return [jnp.asarray(x).astype(JNP[dtype]) for x in xs]


def _assert_close(got, want, dtype, what):
    """f32: the sides differ only in the order of a few roundings and in the
    bias corrections (host double vs device f32 powers), so within 1e-6 of
    values of order 1. bf16: the f32 results may round to neighbouring bf16
    values, so within one bf16 ulp (2^-8 relative, 2^-7 at the low end of
    a binade)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6,
                                   err_msg=what)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_matches_pallas_update(dtype, weight_decay):
    params, grads = _arrays(0, dtype)
    tp = _to_torch(params, dtype)
    tm = [torch.zeros(p.shape) for p in params]
    tv = [torch.zeros(p.shape) for p in params]
    jp = _to_jax(params, dtype)
    jm = [jnp.zeros(p.shape, jnp.float32) for p in params]
    jv = [jnp.zeros(p.shape, jnp.float32) for p in params]
    fadam.launches = 0
    for step, g in enumerate(grads, start=1):
        fadam.fused_adamw_update(tp, _to_torch(g, dtype), tm, tv, 1e-2, step,
                                 weight_decay=weight_decay, **HYPER)
        out = [jax_fused_adamw_update(p, gg, m, v, 1e-2, step,
                                      weight_decay=weight_decay, **HYPER)
               for p, gg, m, v in zip(jp, _to_jax(g, dtype), jm, jv)]
        jp, jm, jv = (list(x) for x in zip(*out))
    for i in range(len(SHAPES)):
        _assert_close(tp[i], jp[i], dtype, f"p[{i}]")
        np.testing.assert_allclose(tm[i].numpy(), np.asarray(jm[i]),
                                   rtol=1e-6, atol=1e-8, err_msg=f"m[{i}]")
        np.testing.assert_allclose(tv[i].numpy(), np.asarray(jv[i]),
                                   rtol=1e-6, atol=1e-10, err_msg=f"v[{i}]")
    assert fadam.launches == 0, "a CPU tensor must not count as a kernel launch"


def test_fused_adamw_reads_the_schedule_before_the_increment():
    """FusedAdamW over 3 steps with a linear warmup from lr 0: the first
    step must see lr(0) = 0 and leave the parameters alone, as the JAX
    ``fused_adamw`` transformation does."""
    dtype = torch.float32
    params, grads = _arrays(1, dtype)
    kw = dict(warmup_min_lr=0.0, warmup_max_lr=1e-2, warmup_num_steps=3,
              warmup_type="linear")
    opt = fadam.FusedAdamW(_to_torch(params, dtype),
                           lr_schedules.warmup_lr_fn(**kw), weight_decay=0.1,
                           **HYPER)
    tx = fused_adamw(jax_lr_schedules.warmup_lr_fn(**kw), weight_decay=0.1,
                     **HYPER)
    jp = _to_jax(params, dtype)
    state = tx.init(jp)
    for step, g in enumerate(grads):
        opt.step(_to_torch(g, dtype))
        updates, state = tx.update(_to_jax(g, dtype), state, jp)
        jp = optax.apply_updates(jp, updates)
        if step == 0:
            for p, p0 in zip(opt.params, params):
                np.testing.assert_array_equal(p.numpy(), p0)
    assert opt.count == int(state.count) == 3
    for i in range(len(SHAPES)):
        _assert_close(opt.params[i], jp[i], dtype, f"p[{i}]")
        np.testing.assert_allclose(opt.mu[i].numpy(), np.asarray(state.mu[i]),
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("scheduled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_matches_optax(dtype, scheduled, adam_w_mode):
    """The plain AdamW (moments in the parameter dtype) against optax.adamw,
    or against add_decayed_weights + adam with ``adam_w_mode=False``."""
    params, grads = _arrays(2, dtype)
    kw = dict(warmup_min_lr=1e-3, warmup_max_lr=1e-2, warmup_num_steps=2,
              warmup_type="linear")
    lr_t = lr_schedules.warmup_lr_fn(**kw) if scheduled else 1e-2
    lr_j = jax_lr_schedules.warmup_lr_fn(**kw) if scheduled else 1e-2
    opt = AdamW(_to_torch(params, dtype), lr_t, weight_decay=0.1,
                adam_w_mode=adam_w_mode, **HYPER)
    if adam_w_mode:
        tx = optax.adamw(lr_j, weight_decay=0.1, **HYPER)
    else:
        tx = optax.chain(optax.add_decayed_weights(0.1), optax.adam(lr_j, **HYPER))
    jp = _to_jax(params, dtype)
    state = tx.init(jp)
    for g in grads:
        opt.step(_to_torch(g, dtype))
        updates, state = tx.update(_to_jax(g, dtype), state, jp)
        jp = optax.apply_updates(jp, updates)
    adam_state = state[0] if adam_w_mode else state[1][0]
    for i in range(len(SHAPES)):
        assert opt.params[i].dtype == opt.mu[i].dtype == dtype
        _assert_close(opt.params[i], jp[i], dtype, f"p[{i}]")
        _assert_close(opt.mu[i], adam_state.mu[i], dtype, f"mu[{i}]")
        _assert_close(opt.nu[i], adam_state.nu[i], dtype, f"nu[{i}]")


@pytest.mark.parametrize("opt_type,params,use_pallas,want", [
    ("FusedAdam", {}, True, "FusedAdamW"),
    ("Adam", {}, True, "FusedAdamW"),
    ("AdamW", {}, True, "FusedAdamW"),
    ("FusedAdam", {}, False, "AdamW"),
    ("Adam", {"adam_w_mode": False}, True, "AdamW"),
    ("Lamb", {}, True, "Lamb"),
    ("FusedLamb", {}, False, "Lamb"),
    ("Adagrad", {}, True, "Adagrad"),
    ("SGD", {"momentum": 0.9}, True, "SGD"),
])
def test_build_optimizer_follows_the_jax_rules(opt_type, params, use_pallas,
                                               want):
    opt = build_optimizer([torch.zeros(3)], opt_type, params,
                          use_pallas=use_pallas)
    assert type(opt).__name__ == want


@pytest.mark.parametrize("opt_type", ["OneBitAdam", "ZeroOneAdam",
                                     "OneBitLamb"])
def test_unported_optimizers_raise(opt_type):
    """The 1-bit family is ported (``runtime/fp16/onebit/``): without the
    engine's compression axis ``build_optimizer`` falls back to the
    uncompressed rule, as the JAX one does; the 1-bit optimizer itself
    raises without the axis size, with the JAX words."""
    from deepspeed_tpu_torch.runtime.fp16 import onebit

    opt = build_optimizer([torch.zeros(3)], opt_type, {})
    assert type(opt).__name__ == ("Lamb" if "Lamb" in opt_type else "AdamW")
    cls = {"OneBitAdam": onebit.OnebitAdam, "ZeroOneAdam": onebit.ZeroOneAdam,
           "OneBitLamb": onebit.OnebitLamb}[opt_type]
    with pytest.raises(ValueError, match="pass axis_size"):
        cls([torch.zeros(3)])
    built = build_optimizer([torch.zeros(3)], opt_type, {},
                            compression_axis="dp", compression_axis_size=2)
    assert isinstance(built, cls)


def _float_reference(params, grads, ms, vs, lr, step, *, b1, b2, eps,
                     weight_decay):
    """The kernel's update from host floats (the plain version's form
    before lr, c1 and c2 moved to device scalars)."""
    c1, c2 = (torch.tensor(1.0 - b ** step, dtype=torch.float32)
              for b in (b1, b2))
    for p, g, m, v in zip(params, grads, ms, vs):
        gf = g.float()
        m.mul_(b1).add_(gf * (1.0 - b1))
        v.mul_(b2).add_(gf * (1.0 - b2) * gf)
        update = (m / c1) / ((v / c2).sqrt_() + eps)
        pf = p.float()
        pf.sub_(lr * (update + weight_decay * pf))
        p.copy_(pf)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_reference_from_device_scalars_is_bit_identical(dtype):
    """``fused_adamw_reference`` reading lr, c1 and c2 from the f32 scalar
    buffer gives the float-argument update bit for bit over 3 steps; with
    the skip flag set it leaves p, m and v exactly as they were."""
    params, grads = _arrays(3, dtype)
    kw = dict(weight_decay=0.1, **HYPER)
    state = {name: ([torch.tensor(p).to(dtype) for p in params],
                    [torch.zeros(p.shape) for p in params],
                    [torch.zeros(p.shape) for p in params])
             for name in ("floats", "scalars")}
    for step, g in enumerate(grads, start=1):
        tg = _to_torch(g, dtype)
        _float_reference(*state["floats"][:1], tg, *state["floats"][1:],
                         2e-2, step, **kw)
        scalars = fadam.adamw_scalars(2e-2, step, HYPER["b1"], HYPER["b2"],
                                      "cpu")
        fadam.fused_adamw_reference(*state["scalars"][:1], tg,
                                    *state["scalars"][1:], scalars, **kw)
        for a, b in zip(state["floats"], state["scalars"]):
            for x, y in zip(a, b):
                assert torch.equal(x, y), f"step {step}"
    before = [[x.clone() for x in xs] for xs in state["scalars"]]
    skipped = fadam.adamw_scalars(2e-2, 4, HYPER["b1"], HYPER["b2"], "cpu",
                                  skip=True)
    fadam.fused_adamw_reference(*state["scalars"][:1], _to_torch(grads[0], dtype),
                                *state["scalars"][1:], skipped, **kw)
    for a, b in zip(before, state["scalars"]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_fused_adamw_prepare_apply_commit():
    """``FusedAdamW``'s three parts: ``apply`` with a set skip flag leaves
    every tensor alone, and ``commit(False)`` keeps the count, so the next
    step repeats the skipped one's lr and bias corrections; a full step
    then equals ``fused_adamw_update`` at step 1."""
    dtype = torch.bfloat16
    params, grads = _arrays(4, dtype)
    opt = fadam.FusedAdamW(_to_torch(params, dtype), 1e-2, weight_decay=0.1,
                           **HYPER)
    g = _to_torch(grads[0], dtype)
    opt.prepare()
    opt.apply(g, skip=torch.tensor(True))
    opt.commit(False)
    assert opt.count == 0
    for p, p0 in zip(opt.params, _to_torch(params, dtype)):
        assert torch.equal(p, p0)
    assert not any(m.any() for m in opt.mu)
    opt.step(g)
    assert opt.count == 1
    want = _to_torch(params, dtype)
    ms = [torch.zeros(p.shape) for p in params]
    vs = [torch.zeros(p.shape) for p in params]
    fadam.fused_adamw_update(want, g, ms, vs, 1e-2, 1, weight_decay=0.1,
                             **HYPER)
    for a, b in zip(opt.params + opt.mu + opt.nu, want + ms + vs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adamw_skip_and_split_step(adam_w_mode):
    """The plain AdamW: ``apply`` with a set skip flag changes nothing;
    with a clear one, ``prepare``/``apply``/``commit`` equals ``step``."""
    dtype = torch.bfloat16
    params, grads = _arrays(5, dtype)
    a = AdamW(_to_torch(params, dtype), 1e-2, weight_decay=0.1,
              adam_w_mode=adam_w_mode, **HYPER)
    b = AdamW(_to_torch(params, dtype), 1e-2, weight_decay=0.1,
              adam_w_mode=adam_w_mode, **HYPER)
    for step, g in enumerate(grads):
        tg = _to_torch(g, dtype)
        a.prepare()
        a.apply(tg, skip=torch.tensor(True))
        a.commit(False)
        a.prepare()
        a.apply(tg, skip=torch.tensor(False))
        a.commit(True)
        b.step(tg)
        assert a.count == b.count == step + 1
        for x, y in zip(a.params + a.mu + a.nu, b.params + b.mu + b.nu):
            assert torch.equal(x, y)


def test_pointer_table_under_capture_takes_a_spare():
    """While a graph is captured, B4's pointer table is a spare buffer made
    before the capture (a buffer from the graph's pool may be one that
    earlier nodes of the graph overwrite on every replay), filled once the
    capture has ended, held by the graph, and replaced by a new spare; with
    no spare the capture raises."""
    from deepspeed_tpu_torch.runtime import compiled_step

    params = [torch.zeros(s) for s in ((3, 5), (7,))]
    group = [(p, torch.ones_like(p), torch.zeros_like(p), torch.zeros_like(p))
             for p in params]
    fadam._SPARES.clear()
    state = compiled_step._CaptureState()
    compiled_step._capture = state
    try:
        with pytest.raises(RuntimeError, match="uncaptured first"):
            fadam._table(group, torch.device("cpu"))
        fadam._reserve(torch.device("cpu"), 2)
        spare = fadam._SPARES[("cpu", 2)]
        table, rows, chunks = fadam._table(group, torch.device("cpu"))
    finally:
        compiled_step._capture = None
    assert table is spare and (rows, chunks) == (2, 2)
    assert any(h is table for h in state.held)
    for fn in state.after:
        fn()
    want = [[p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel(), i]
            for i, (p, g, m, v) in enumerate(group)]
    assert table.tolist() == want
    assert fadam._SPARES[("cpu", 2)] is not table
    fadam._TABLES.clear()
    fadam._SPARES.clear()
