"""The 1-bit optimizers of the port (``OneBitAdam``, ``OneBitLamb``,
``ZeroOneAdam``) on 2 gloo ranks against the JAX engine on a 2-device dp
mesh, with ``test_torch_grad_exchange.py``'s harness.

Each step is compared from the same state: the JAX engine runs 4 steps,
and before each of its own steps the port loads the JAX engine's
parameters and optimizer state of the step before (``_restore_module``
and ``compressed_state_from_jax``: count, moments and each rank's error
feedback), so that one step's rounding is all that separates the two. A
free run is not compared: sign compression turns the rounding noise of an
element near 0 into a full step of the chunk's scale, and Adam's division
by a small frozen variance then gives that element an update far from the
other side's, so two free runs part after the first compressed step, the
JAX engine's own runs on another backend too.

1-bit Adam runs with ``freeze_step`` 2, so steps 1-2 are the exact
warm-up and 3-4 the compressed phase (one captured graph each on a card),
at ZeRO stages 0 and 1 (at stage 1 the state stays replicated and dp stays
dp) and at gas 2; 1-bit LAMB under both layouts (its trust ratio is per
JAX leaf, so a scanned leaf stacks the layers); 0/1 Adam with a variance
refresh every 2 steps (steps 1, 2 and 4 refresh). Per step: the loss to
1e-5 relative; the parameters' updates to 1e-3 in relative L2, leaving
out the key third of ``c_attn.bias``, whose gradient is 0 in exact
arithmetic: after sign compression its elements take the chunk's scale
with the sign of rounding noise, on each side its own (it does not change
the loss: softmax ignores a shift per row). The moments and the error
feedback of every other leaf (the whole ``c_attn.bias`` is left out: the
noise's signs also set the scales of the chunks it shares) agree to 1e-3
of each tensor's largest entry, but for at most 0.5% of the elements: an
element whose value before a compression is 0 to the last bits may take
the other sign on the other side, a step of twice the chunk's scale (one
such element is ~2% of a 12288-element leaf in relative L2).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_grad_exchange as tgx  # noqa: E402
import test_torch_zero as tz  # noqa: E402

# an element that took the other sign in one of the step's compressions
REL_TOL = 1e-3
FLIP_SHARE = 5e-3
SERVER_REL_L2 = 2e-2
STEPS1 = tz.global_batches(4, 1, seed=31)
STEPS2 = tz.global_batches(4, 2, seed=32)
C = tz.SMALL["n_embd"]


def onebit(kind, stage=0, gas=1, **params):
    return tz.config(stage, gas, optimizer={"type": kind, "params": dict(
        dict(lr=tz.LR, weight_decay=0.1), **params)})


RUNS = {
    "adam_s0": (onebit("OneBitAdam", freeze_step=2), STEPS1, True),
    "adam_s1": (onebit("OneBitAdam", stage=1, freeze_step=2), STEPS1, True),
    "adam_gas2": (onebit("OneBitAdam", gas=2, freeze_step=2), STEPS2, True),
    "lamb": (onebit("OneBitLamb", freeze_step=2), STEPS1, True),
    "lamb_unscanned": (onebit("OneBitLamb", freeze_step=2), STEPS1, False),
    # at lr 1e-3 0/1 Adam's first steps (sign-compressed momentum over a
    # variance refreshed from one gradient) throw the small model far off
    # (loss 5.2 -> 9-12 on both sides); at 1e-4 it stays where f32 holds
    "zero_one": (onebit("ZeroOneAdam", var_update_period=2, lr=1e-4),
                 STEPS1, True),
}


def jax_steps(ds, steps, scan_layers):
    """The JAX engine one step at a time: the state before each step and
    after it (port names; the optimizer state for each rank)."""
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.parallel.mesh import MeshTopology
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import (
        compressed_state_from_jax, gpt_state_dict_from_jax)

    jmodel, params = tz.jax_init(scan_layers)
    cfg = tlm.GPTConfig(**tz.SMALL, dtype=torch.float32,
                        scan_layers=scan_layers)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=tz.WORLD, devices=jax.devices()[:tz.WORLD]))
    losses, before, after = [], [None], []

    def snapshot():
        opt = jax.device_get(jeng._opt_state)
        return {"params": gpt_state_dict_from_jax(
                    jax.device_get(jeng.params), cfg),
                "opt": {r: compressed_state_from_jax(opt, cfg, "onebit", r,
                                                     tz.WORLD)
                        for r in range(tz.WORLD)}}

    for step in steps:
        losses.append(float(jeng.train_batch(iter(step))))
        after.append(snapshot())
        before.append(after[-1])
    before = before[:len(steps)]
    return losses, before, after


@pytest.fixture(scope="module")
def forced(tmp_path_factory):
    """Every run's JAX steps, and the port's steps from the JAX state."""
    jax_side = {name: jax_steps(ds, steps, scan)
                for name, (ds, steps, scan) in RUNS.items()}
    inits = {True: tgx.init_state(True), False: tgx.init_state(False)}
    jobs = []
    for name, (ds, steps, scan) in RUNS.items():
        _, before, _ = jax_side[name]
        # step 1 starts from the init (the port's own zero state), the
        # others from the JAX state before them
        jobs.append(tz.job(name, ds, steps[:1], init=inits[scan],
                           model={"scan_layers": scan}, record=True))
        jobs.append(tz.job(f"{name}_forced", ds, steps[1:], init=inits[scan],
                           model={"scan_layers": scan},
                           forced=before[1:]))
    return jax_side, tgx.run_ranks(jobs, tmp_path_factory.mktemp("forced"))


def _key_third_out(name, t):
    """``t`` without the key third of a ``c_attn.bias`` (flattened)."""
    t = t.reshape(-1).float()
    if name.endswith("attn.c_attn.bias"):
        return torch.cat([t[:C], t[2 * C:]])
    return t


def leaf_paths(scan_layers):
    """The JAX leaf paths of the small GPT, in the exchange's order."""
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_exchange_layout

    cfg = tlm.GPTConfig(**tz.SMALL, dtype=torch.float32,
                        scan_layers=scan_layers)
    named = [(n, p.shape) for n, p in tlm.GPT(cfg).named_parameters()]
    return [path for path, _ in gpt_exchange_layout(named, cfg).leaves]


def assert_few_flips(pairs, what):
    """``got`` against ``want`` per tensor: equal to ``REL_TOL`` of the
    tensor's largest entry but for at most ``FLIP_SHARE`` of the elements
    (the ones that took the other sign in a compression)."""
    bad = total = 0
    for a, b in pairs:
        tol = REL_TOL * float(b.abs().max()) + 1e-30
        bad += int(((a.float() - b.float()).abs() > tol).sum())
        total += b.numel()
    assert bad <= FLIP_SHARE * total, (what, bad, total)


def _rel_l2(pairs):
    diff = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
    norm = sum(float((b ** 2).sum()) for _, b in pairs)
    return (diff / max(norm, 1e-30)) ** 0.5


def _port_steps(runs, name, rank):
    """The port's state after each of the 4 steps on ``rank``: step 1 from
    the first job, the others from the forced job."""
    first, rest = runs[rank][name], runs[rank][f"{name}_forced"]
    return ([{"params": first["params"], "moments": first["moments"],
              "exchange": first["final_exchange"],
              "loss": first["losses"][0]}]
            + [dict(s, loss=l) for s, l in zip(rest["forced"],
                                               rest["losses"])])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_each_step_matches_jax(name, forced):
    jax_side, runs = forced
    losses, before, after = jax_side[name]
    for rank in range(tz.WORLD):
        for i, got in enumerate(_port_steps(runs, name, rank)):
            want = after[i]
            start = (before[i]["params"] if before[i] is not None
                     else runs[rank][name]["start_params"])
            np.testing.assert_allclose(got["loss"], losses[i],
                                       rtol=tz.LOSS_RTOL)
            upd = [(_key_third_out(k, got["params"][k] - start[k]),
                    _key_third_out(k, want["params"][k] - start[k]))
                   for k in want["params"]]
            assert _rel_l2(upd) <= tz.UPDATE_REL_L2, (i, _rel_l2(upd))
            ref = want["opt"][rank]
            paths = leaf_paths(RUNS[name][2])
            for key in ("exp_avg", "exp_avg_sq"):
                assert_few_flips(
                    [(got["moments"][k][key], st[key])
                     for k, st in ref["optimizer"]["state"].items()
                     if "c_attn.bias" not in k], (name, rank, i, key))
            for field in ("worker_error", "server_error"):
                pairs = [p for path, p in zip(paths, zip(
                    got["exchange"][field], ref["grad_exchange"][field]))
                    if "c_attn/bias" not in path]
                assert all(a.shape == b.shape for a, b in pairs)
                if field == "worker_error":
                    assert_few_flips(pairs, (name, rank, i, field))
                else:
                    # a flip in phase 1 moves its chunk's server scale, so
                    # every residual of that chunk shifts a little
                    assert _rel_l2(pairs) <= SERVER_REL_L2, (
                        name, rank, i, _rel_l2(pairs))
    # no grad norm without the debug all-reduce, as in the JAX engine
    assert runs[0][name]["norms"] == [None]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Free runs of the port alone: its ranks, phases and checkpoints."""
    init = tgx.init_state(True)
    ckpt = str(tmp_path_factory.mktemp("onebit_ckpt"))
    ds = RUNS["adam_s0"][0]
    jobs = [tz.job("adam_s0", ds, STEPS1, init=init, record=True),
            tz.job("save", ds, STEPS1, init=init,
                   save={"dir": ckpt, "after": 1}),
            tz.job("resume", ds, STEPS1[1:], seed=7, load=ckpt),
            tz.job("refuse_stage2", onebit("OneBitAdam", stage=2), [],
                   raises=True),
            tz.job("debug_norm", dict(ds, tpu={"compressed_grad_norm": True}),
                   STEPS1[:1], init=init)]
    return tgx.run_ranks(jobs, tmp_path_factory.mktemp("onebit"))


def test_ranks_agree_and_phases(runs):
    """Both ranks hold the same parameters bit for bit; before
    ``freeze_step`` the error feedback stays 0 (the exact all-reduce),
    from it on it moves."""
    tgx.assert_ranks_agree(runs, "adam_s0")
    ex = runs[0]["adam_s0"]["exchange"]
    zero = [all(float(b.abs().max()) == 0 for b in e["worker_error"])
            for e in ex]
    assert zero == [True, True, False, False]


def test_checkpoint_across_the_freeze_step(runs):
    """Saved after the first step (warm-up), resumed into a new engine: the
    next 3 steps (one warm-up, two compressed) equal the uninterrupted
    run's bit for bit."""
    for r in runs:
        full, resumed = r["save"], r["resume"]
        assert resumed["losses"] == full["losses"][1:]
        for k, v in full["params"].items():
            assert torch.equal(resumed["params"][k], v), k
        for field, bufs in full["final_exchange"].items():
            for x, y in zip(resumed["final_exchange"][field], bufs):
                assert torch.equal(x, y), field


def test_refusal_and_debug_norm(runs):
    for r in runs:
        kind, msg = r["refuse_stage2"]["error"]
        assert ("onebit compressed gradient exchange requires ZeRO stage "
                "<= 1 (got 2)") in msg
        assert r["debug_norm"]["norms"][0] > 0
