"""The pieces of the port's captured step, on the CPU.

The loss-scale update on device tensors is held to the JAX package's
``update_loss_scale`` exactly over seeded overflow sequences. The clip factor
from a device bound equals the one from a float. ``CompiledStep`` on the CPU
calls its function (the card captures it; ``chip_smoke.py`` holds the
captured steps to the uncaptured ones there), and the launch-count helpers
read and reset every kernel's counter.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import loss_scaler as jls
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu_torch.ops.cuda import fused_adam as fadam
from deepspeed_tpu_torch.runtime import compiled_step
from deepspeed_tpu_torch.runtime import loss_scaler as tls
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.utils import clip_factor, clip_grad_norm_


def _fp16(hysteresis, **over):
    block = {"enabled": True, "initial_scale_power": 5, "hysteresis": hysteresis,
             "loss_scale_window": 3, "min_loss_scale": 2.0, **over}
    ds = {"train_micro_batch_size_per_gpu": 1, "fp16": block}
    return DeepSpeedConfig(ds).fp16, JaxDeepSpeedConfig(ds).fp16


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("hysteresis", [1, 2])
def test_update_loss_scale_matches_jax(hysteresis, seed):
    """10 overflows, then 30 steps of a seeded overflow sequence (window
    3, floor 2.0 from 2^5, so both the floor and the doubling are
    reached): scale, good steps and hysteresis equal the JAX state after
    every step."""
    tcfg_in, jcfg_in = _fp16(hysteresis)
    tstate, tcfg = tls.init_loss_scale(tcfg_in)
    jstate, jcfg = jls.init_loss_scale(jcfg_in)
    overflows = np.r_[np.ones(10, bool),
                      np.random.RandomState(seed).rand(30) < 0.3]
    saw_floor = saw_growth = False
    for i, o in enumerate(overflows):
        before = float(tstate.scale)
        tstate = tls.update_loss_scale(tstate, torch.tensor(bool(o)), tcfg)
        jstate = jls.update_loss_scale(jstate, jnp.bool_(o), jcfg)
        got = (float(tstate.scale), int(tstate.good_steps),
               int(tstate.hysteresis))
        want = (float(jstate.scale), int(jstate.good_steps),
                int(jstate.hysteresis))
        assert got == want, f"step {i}: {got} != {want}"
        assert tstate.scale.dtype == torch.float32
        assert tstate.good_steps.dtype == tstate.hysteresis.dtype == torch.int32
        saw_floor |= bool(o) and before == 2.0
        saw_growth |= float(tstate.scale) > before
    assert saw_floor and saw_growth


def test_static_loss_scale_and_in_place_copy():
    """A static scale never moves; ``copy_`` writes a new state into the
    tensors of the old (a captured step keeps their addresses)."""
    tcfg_in, _ = _fp16(1, loss_scale=128.0)
    state, cfg = tls.init_loss_scale(tcfg_in)
    assert not cfg.dynamic
    assert tls.update_loss_scale(state, torch.tensor(True), cfg) is state
    assert float(state.scale) == 128.0
    tcfg_in, _ = _fp16(2)
    state, cfg = tls.init_loss_scale(tcfg_in)
    ptrs = [t.data_ptr() for t in (state.scale, state.good_steps,
                                   state.hysteresis)]
    state.copy_(tls.update_loss_scale(state, True, cfg))
    assert [t.data_ptr() for t in (state.scale, state.good_steps,
                                   state.hysteresis)] == ptrs
    assert (float(state.scale), int(state.good_steps),
            int(state.hysteresis)) == (32.0, 0, 1)


def test_clip_factor_from_a_device_bound():
    """The clip bound as an f32 tensor gives the float bound's factor and
    clipped gradients bit for bit."""
    rng = np.random.RandomState(0)
    grads = [torch.from_numpy(rng.randn(*s).astype(np.float32))
             for s in ((7, 5), (13,), (3, 3, 3))]
    bound = torch.tensor(0.3, dtype=torch.float32)
    norm = torch.linalg.vector_norm(torch.cat([g.flatten() for g in grads]))
    assert torch.equal(clip_factor(norm, 0.3), clip_factor(norm, bound))
    a, b = [g.clone() for g in grads], [g.clone() for g in grads]
    na, nb = clip_grad_norm_(a, 0.3), clip_grad_norm_(b, bound)
    assert torch.equal(na, nb)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_compiled_step_calls_its_function_on_the_cpu():
    """On the CPU every call is the function itself, ``eager`` included;
    no graph is kept."""
    calls = []

    def fn(k, *, x):
        calls.append(k)
        return x * k, None

    step = compiled_step.CompiledStep(fn, "cpu")
    x = torch.arange(4.0)
    for _ in range(3):
        out, none = step({"x": x}, 2)
        assert torch.equal(out, x * 2) and none is None
    assert torch.equal(step.eager({"x": x}, 3)[0], x * 3)
    assert calls == [2, 2, 2, 3] and not step.graphs


def test_launch_counts_and_capture_helpers():
    """The launch counters read and reset as one; outside a capture
    ``hold`` keeps nothing and ``after_capture`` runs at once."""
    compiled_step.reset_launch_counts()
    assert set(compiled_step.launch_counts().values()) == {0}
    fadam.launches = 3
    assert compiled_step.launch_counts()["fused_adamw"] == 3
    compiled_step.reset_launch_counts()
    assert fadam.launches == 0
    assert not compiled_step.capturing()
    ran = []
    compiled_step.hold(object())
    compiled_step.after_capture(lambda: ran.append(1))
    assert ran == [1]
