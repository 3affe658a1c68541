"""ZeRO stage 3 of the port on 2 gloo ranks (and 4 on a (dp 2, fsdp 2)
mesh), against the JAX engine at stage 3 on a 2-device fsdp mesh with the
same ``stage3_param_persistence_threshold`` and against the port's own
one-process engine at twice the accumulation steps.

The harness, data and tolerances are ``test_torch_zero.py``'s: a small f32
GPT (2 layers, width 64, seq 32) from the JAX init, global micro batches of
4 rows, the ranks as child processes with their own timeouts; losses to
1e-5 relative, updates to 1e-3 in relative L2, both ranks bit for bit.

Thresholds: 0 partitions every leaf (as the JAX package's own stage-3 tests
do); 5000 keeps the biases, the LayerNorms, the position table (4096) and
the attention projection (4096) whole, so a block holds both kinds. One
case runs with full remat, whose recompute gathers each block again.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_zero as tz  # noqa: E402

MIXED = 5000
# (threshold, gas, remat)
CASES = [(0, 1, False), (0, 2, False), (MIXED, 1, False), (MIXED, 2, False),
         (MIXED, 1, True)]


def config3(threshold, gas=1, **over):
    return tz.config(3, gas, zero_optimization={
        "stage": 3, "stage3_param_persistence_threshold": threshold}, **over)


def case_name(threshold, gas, remat):
    return f"t{threshold}g{gas}" + ("remat" if remat else "")


def partitioned(threshold):
    """The names stage 3 partitions at ``threshold`` (the small GPT's
    leaves of at least that many elements)."""
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    model = tlm.GPT(tlm.GPTConfig(**tz.SMALL, dtype=torch.float32))
    return {n for n, p in model.named_parameters()
            if p.numel() >= max(threshold, 1)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 2-rank stage-3 case of this file, in one spawn."""
    import jax

    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    init = gpt_state_dict_from_jax(
        jax.device_get(tz.jax_init()[1]),
        tlm.GPTConfig(**tz.SMALL, dtype=torch.float32))
    jobs = [tz.job(case_name(t, g, r), config3(t, g), tz.MATRIX_STEPS[g],
                   init=init, model={"remat": r})
            for t, g, r in CASES]
    jobs += [tz.job(f"comms_t{t}" + ("remat" if r else ""),
                    config3(t, comms_logger={"enabled": True}),
                    tz.MATRIX_STEPS[1][:1], init=init, model={"remat": r},
                    comms=True)
             for t in (0, MIXED) for r in (False, True)]
    jobs += [tz.job(f"live{'remat' if r else ''}", config3(0), [],
                    init=init, model={"remat": r},
                    liveness=tz.MATRIX_STEPS[1][0][0])
             for r in (False, True)]
    jobs += [
        tz.job("offload", tz.config(3, zero_optimization={
            "stage": 3, "offload_param": {"device": "cpu"}}), [],
            raises=True),
        tz.job("moe", config3(0), [], raises=True,
               model={"moe_num_experts": 2, "moe_top_k": 1}),
    ]
    return {"ranks": tz.run_ranks(jobs, tmp_path_factory.mktemp("zero3")),
            "init": init}


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(threshold, gas, remat):
        key = (threshold, gas, remat)
        if key not in cache:
            cache[key] = tz.jax_run(config3(threshold, gas),
                                    tz.MATRIX_STEPS[gas],
                                    model={"remat": remat})
        return cache[key]
    return get


@pytest.mark.parametrize("threshold,gas,remat", CASES)
def test_stage3_matches_jax(threshold, gas, remat, runs, jax_runs):
    name = case_name(threshold, gas, remat)
    tz.assert_ranks_agree(runs["ranks"], name)
    got, want = runs["ranks"][0][name], jax_runs(threshold, gas, remat)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(got["params"], want["params"], want["start"])
    assert got["count"] == tz.K
    assert got["global_samples"] == tz.K * gas * tz.MICRO * tz.WORLD


@pytest.mark.parametrize("threshold,gas,remat", CASES)
def test_stage3_matches_one_process(threshold, gas, remat, runs):
    name = case_name(threshold, gas, remat)
    got = runs["ranks"][1][name]
    ref = tz.one_process(tz.config(0, 2 * gas), tz.MATRIX_STEPS[gas],
                         runs["init"])
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(got["params"], ref["params"], runs["init"])
    np.testing.assert_allclose(got["norms"][-1],
                               ref["engine"].get_global_grad_norm(),
                               rtol=tz.LOSS_RTOL)


@pytest.mark.parametrize("threshold", [0, MIXED])
def test_partitioned_parameters_live_only_as_shards(threshold, runs):
    """Each partitioned parameter is an empty placeholder on the module
    (its name kept), the whole leaves stay whole, and the rank's shards
    hold half of the padded model."""
    from deepspeed_tpu_torch.runtime.zero.sharding import ALIGN

    split = partitioned(threshold)
    for r in runs["ranks"]:
        got = r[case_name(threshold, 1, False)]
        assert got["module_numels"].keys() == got["params"].keys()
        for name, numel in got["module_numels"].items():
            whole = got["params"][name].numel()
            assert numel == (0 if name in split else whole), name
        total = sum(v.numel() for v in got["params"].values())
        assert total / 2 <= sum(got["shard_numels"]) <= (
            total / 2 + 20 * ALIGN)
    assert (threshold == 0) == (len(split) == len(runs["init"]))


@pytest.mark.parametrize("threshold", [0, MIXED])
@pytest.mark.parametrize("remat", [False, True])
def test_collectives_per_step(threshold, remat, runs):
    """One step's collectives, from the comms logger: an all-gather per
    unit in the forward (the outer unit and each block), one more per block
    in the remat recompute, and the whole leaves' all-gather after the
    update; a reduce-scatter per unit in the backward and the whole leaves'
    one; three all-reduces (the loss weights, the loss, the norm). The
    all-gathers move each shard once (each block's twice under remat) and
    the reduce-scatters each full unit once: no whole-model gather."""
    n_layer = tz.SMALL["n_layer"]
    units = n_layer + 1
    whole = 1 if threshold else 0
    for r in runs["ranks"]:
        got = r[f"comms_t{threshold}" + ("remat" if remat else "")]
        counts = {k: v["count"] for k, v in got["comms"].items()}
        assert counts == {
            "all_gather": units + (n_layer if remat else 0) + whole,
            "reduce_scatter": units + whole,
            "all_reduce": 3}, counts
        # f32 shards: the whole leaves' group, the outer unit's, then one
        # per block
        shards = got["shard_numels"]
        assert len(shards) == whole + units
        gathered = 4 * (sum(shards) + (sum(shards[-n_layer:]) if remat
                                       else 0))
        assert got["comms"]["all_gather"]["bytes"] == gathered
        assert got["comms"]["reduce_scatter"]["bytes"] == (
            4 * tz.WORLD * sum(shards))


@pytest.mark.parametrize("remat", [False, True])
def test_gathered_buffers_do_not_outlive_their_unit(remat, runs):
    """Under full remat a block's gathered buffer dies with the block:
    after the forward only the outer unit's is alive (the embedding and the
    tied head keep it for the backward), so the state held for the
    backward does not grow with the depth by a unit per block; the
    recompute gathers each block again. Without remat every block's buffer
    lives until its backward. After the backward none is alive. (The
    probe, ``test_torch_zero._gathered_liveness``, gives gloo's worker
    thread time to drop the output of a collective that has completed.)"""
    units = tz.SMALL["n_layer"] + 1
    for r in runs["ranks"]:
        got = r[f"live{'remat' if remat else ''}"]["liveness"]
        assert got["forward_made"] == units, got
        assert got["forward_alive"] == (1 if remat else units), got
        assert got["made"] == units + (tz.SMALL["n_layer"] if remat else 0), \
            got
        assert got["alive"] == 0, got


@pytest.mark.parametrize("name,words", [
    ("offload", "ROADMAP A.10"),
    ("moe", "ROADMAP A.3"),
])
def test_stage3_refusals(name, words, runs):
    for r in runs["ranks"]:
        kind, msg = r[name]["error"]
        assert kind == "NotImplementedError" and words in msg, msg


HSDP_STEPS = tz.global_batches(tz.K, 1, seed=9, world=4)


def test_stage3_on_dp_by_fsdp_mesh(tmp_path):
    """4 gloo ranks on a (dp 2, fsdp 2) mesh at stage 3: the gathers and
    reduce-scatters over fsdp, each shard gradient all-reduced over dp;
    against the JAX engine on the same mesh and the one-process engine."""
    import jax

    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    init = gpt_state_dict_from_jax(
        jax.device_get(tz.jax_init()[1]),
        tlm.GPTConfig(**tz.SMALL, dtype=torch.float32))
    ds = config3(MIXED, tpu={"mesh": {"dp": 2, "fsdp": 2}})
    per_rank = tz.run_ranks([tz.job("hsdp3", ds, HSDP_STEPS, init=init)],
                            tmp_path, world=4)
    a = per_rank[0]["hsdp3"]
    for r in per_rank[1:]:
        assert r["hsdp3"]["losses"] == a["losses"]
        for k, v in a["params"].items():
            assert torch.equal(r["hsdp3"]["params"][k], v), k
    want = tz.jax_run(config3(MIXED), HSDP_STEPS, dp=2, fsdp=2)
    np.testing.assert_allclose(a["losses"], want["losses"], rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(a["params"], want["params"], want["start"])
    ref = tz.one_process(tz.config(0, 4), HSDP_STEPS, init)
    np.testing.assert_allclose(a["losses"], ref["losses"], rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(a["params"], ref["params"], init)
