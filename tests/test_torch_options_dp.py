"""The GPT training options (remat policies, stochastic depth under
progressive layer drop, the fused head + CE, dropout) and the block-sparse
route under a process group: 2 gloo ranks at ZeRO stages 1 and 3 (the
sparse route at stages 0-3) against the port's group-less engine.

The harness is ``test_torch_zero.py``'s: the small f32 GPT from the JAX
init, global micro batches of 4 rows (2 per rank), child processes that
run every job of one stage in one spawn. A deterministic option is held
against the group-less engine at gas = world (each global micro batch
split into the ranks' halves). A random one draws per forward: dropout
masks over the global micro batch (each rank keeps its rows) and the
stochastic-depth gates once per step, equal on every rank, so it is held
against the group-less engine at the global micro batch and gas 1, which
draws the same tensors. Bounds as in ``test_torch_zero.py``: losses and
the last grad norm to 1e-5 relative, parameter updates to 1e-3 in
relative L2. The two ranks' dropout masks at the first site must differ
(the draws are of each rank's own rows).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_zero import (K, LOSS_RTOL, MICRO, MATRIX_STEPS, SMALL,  # noqa: E402
                             WORLD, assert_ranks_agree, assert_updates_close,
                             config, job, one_process, run_ranks)

STEPS = MATRIX_STEPS[1]
# a causal window of one past block of 8 over the 32-token rows
SPARSE = {"mode": "local_sliding_window", "block": 8,
          "num_sliding_window_blocks": 3, "kernel": "pallas"}
PLD = {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                  "gamma": 10.0}}
# option -> (GPTConfig overrides, config blocks, drawn per forward)
OPTIONS = {
    "remat_full": ({"remat": True, "remat_policy": "full"}, {}, False),
    "remat_selective": ({"remat": True, "remat_policy": "selective"}, {},
                        False),
    "remat_save_dots": ({"remat": True, "remat_policy": "save_dots"}, {},
                        False),
    "remat_save_nothing_but_flash": (
        {"remat": True, "remat_policy": "save_nothing_but_flash"}, {}, False),
    "pld": ({"stochastic_mode": True, "n_layer": 4}, PLD, True),
    "fused_head_ce": ({"fused_head_ce": True}, {}, False),
    "dropout": ({"dropout": 0.1, "remat": True}, {}, True),
    # the block-sparse route (B5-B7's plain versions on the CPU) under a
    # policy, and with stochastic depth and the fused head
    "sparse_selective": ({"remat": True, "remat_policy": "selective"},
                         {"sparse_attention": SPARSE}, False),
    "sparse_save_dots_pld_fused_head": (
        {"remat": True, "remat_policy": "save_dots", "stochastic_mode": True,
         "fused_head_ce": True, "n_layer": 4},
        {"sparse_attention": SPARSE, **PLD}, True),
}
STAGES = (0, 1, 2, 3)
# stages 0 and 2 run the sparse route alone
STAGE_OPTIONS = {stage: [o for o in OPTIONS
                         if stage in (1, 3) or o.startswith("sparse")]
                 for stage in STAGES}


@pytest.fixture(scope="module")
def start():
    import jax

    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax
    from test_torch_zero import jax_init

    out = {}
    for n_layer in {over.get("n_layer", SMALL["n_layer"])
                    for over, _, _ in OPTIONS.values()}:
        tcfg = tlm.GPTConfig(**dict(SMALL, n_layer=n_layer),
                             dtype=torch.float32)
        out[n_layer] = gpt_state_dict_from_jax(
            jax.device_get(jax_init(n_layer=n_layer)[1]), tcfg)
    return out


def _init(start, option):
    return start[OPTIONS[option][0].get("n_layer", SMALL["n_layer"])]


@pytest.fixture(scope="module")
def stage_runs(start, tmp_path_factory):
    """Every option at each stage: one spawn of 2 ranks per stage."""
    runs = {}
    for stage in STAGES:
        jobs = [job(name, config(stage, **OPTIONS[name][1]), STEPS,
                    init=_init(start, name), model=OPTIONS[name][0],
                    record_masks=1 if name == "dropout" else 0)
                for name in STAGE_OPTIONS[stage]]
        runs[stage] = run_ranks(jobs, tmp_path_factory.mktemp(f"opt{stage}"))
    return runs


def _global_batch_engine(ds, steps, init, model):
    """The group-less engine on the global micro batches themselves (micro
    ``MICRO * WORLD``, gas 1)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**{**SMALL, **model},
                                    dtype=torch.float32)),
        config=ds, device="cpu",
        model_parameters={k: v.clone() for k, v in init.items()})[0]
    losses = [float(engine.train_batch(iter(s))) for s in steps]
    return {"losses": np.array(losses), "engine": engine,
            "params": {k: v.clone()
                       for k, v in engine.module.state_dict().items()}}


@pytest.fixture(scope="module")
def references(start):
    out = {}
    for name, (over, blocks, drawn) in OPTIONS.items():
        init = _init(start, name)
        if drawn:
            out[name] = _global_batch_engine(
                config(1, micro=MICRO * WORLD, **blocks), STEPS, init, over)
        else:
            out[name] = one_process(config(1, 2, **blocks), STEPS, init,
                                    model=over)
    return out


@pytest.mark.parametrize("stage,option", [
    (stage, option) for stage in STAGES for option in STAGE_OPTIONS[stage]])
def test_option_under_a_group_matches_the_groupless_engine(
        stage, option, stage_runs, references, start):
    runs = stage_runs[stage]
    assert_ranks_agree(runs, option)
    got, ref = runs[0][option], references[option]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["norms"][-1],
                               ref["engine"].get_global_grad_norm(),
                               rtol=LOSS_RTOL)
    assert_updates_close(got["params"], ref["params"], _init(start, option))
    assert got["count"] == K


@pytest.mark.parametrize("stage", (1, 3))
def test_dropout_masks_differ_across_ranks(stage, stage_runs):
    """Each rank keeps its own rows of the global draw: at the first site
    (the embedding's dropout, [2, 32, 64] per rank) the masks differ."""
    a, b = (r["dropout"]["masks"][0] for r in stage_runs[stage])
    assert a.shape == b.shape == (MICRO, 32, SMALL["n_embd"])
    assert not torch.equal(a, b)
    kept = float(torch.cat([a, b]).float().mean())
    assert abs(kept - 0.9) < 0.02
