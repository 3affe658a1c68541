"""BERT under a process group: its training options at ZeRO 0-3, stage 3
against the JAX engine, and the int8 and 1-bit gradient exchanges over its
JAX layout, on 2 gloo ranks.

The harness is ``test_torch_zero.py``'s (the ranks as child processes with
their own timeouts; ``test_torch_grad_exchange.py``'s worker for the
exchanges, which can start a step from the JAX engine's state) with the
tiny BERT of ``test_torch_bert.py`` (2 layers, width 32) from the JAX init,
on the same global micro batches of 4 rows (2 per rank, 32 tokens, every
position labelled).

* Options: dropout 0.1 under full remat, stochastic depth under
  progressive layer drop, and both on the BigBird route (``"pallas"``: the
  plain B5-B7 here) under ``selective``. They draw per forward: each rank
  draws every mask over the global micro batch and keeps its rows, the
  gates once per step and equal on every rank, so a run is held against
  the group-less engine at the global micro batch and gas 1, which draws
  the same tensors; the two ranks' first masks must differ.
* Stage 3 (``encoder.layer.{i}`` units and the outer unit) against the JAX
  engine on a 2-device fsdp mesh, with and without remat, and its units.
* The exchanges against the JAX engine on a 2-device dp mesh in the same
  mode: int8 per leaf (scanned and unscanned layouts) and bucketed over
  the whole run; 1-bit Adam step by step from the JAX engine's state
  (``compressed_state_from_jax``: a free run is not compared, see
  ``test_torch_onebit.py``).

Bounds are ``test_torch_zero.py``'s: losses to 1e-5 relative, updates to
1e-3 in relative L2, the key third of each ``attention.qkv.bias`` apart:
its gradient is zero in exact arithmetic (softmax ignores a shift per
row), so rounding noise there becomes steps of +-lr under Adam (held to
``k * 2 * lr``), and under sign compression steps of the chunk's scale
(left out).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402
import test_torch_grad_exchange as tgx  # noqa: E402
import test_torch_zero as tz  # noqa: E402

C = tz.BERT_TINY["hidden_size"]
STEPS = tz.MATRIX_STEPS[1]
SPARSE = {"mode": "bigbird", "block": 8, "num_random_blocks": 1,
          "num_sliding_window_blocks": 3, "num_global_blocks": 1,
          "kernel": "pallas"}
PLD = {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                  "gamma": 10.0}}
# option -> (BertConfig overrides, config blocks)
OPTIONS = {
    "dropout": ({"dropout": 0.1, "remat": True}, {}),
    "pld": ({"stochastic_mode": True, "num_hidden_layers": 4}, PLD),
    "sparse_dropout_pld_selective": (
        {"dropout": 0.1, "stochastic_mode": True, "remat": True,
         "remat_policy": "selective", "num_hidden_layers": 4},
        {"sparse_attention": SPARSE, **PLD}),
}
STAGES = (0, 1, 2, 3)
INT8 = {"int8_leaf": (tgx.gx_config(**tgx.INT8_LEAF), True),
        "int8_leaf_unscanned": (tgx.gx_config(**tgx.INT8_LEAF), False),
        "int8_bucketed": (tgx.gx_config(**tgx.INT8_BUCKETED), True)}
GX_STEPS = tgx.STEPS
ONEBIT = tz.config(0, optimizer={"type": "OneBitAdam", "params": {
    "lr": tz.LR, "weight_decay": 0.1, "freeze_step": 2}})
ONEBIT_STEPS = tz.global_batches(4, 1, seed=31)
# stage 3 with every leaf partitioned (the tiny BERT's leaves all lie under
# the default persistence threshold)
STAGE3 = tz.config(3, zero_optimization={
    "stage": 3, "stage3_param_persistence_threshold": 0})


def jax_bert(scan_layers=True, **over):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import bert as jbert

    jmodel = jbert.BertForPreTraining(jbert.BertConfig(
        **{**tz.BERT_TINY, **over}, dtype=jnp.float32,
        param_dtype=jnp.float32, scan_layers=scan_layers))
    params = cached_init(jmodel, 0,
                         jnp.zeros((1, tz.SEQ), jnp.int32))["params"]
    return jmodel, params


def port_cfg(scan_layers=True, **over):
    from deepspeed_tpu_torch.models import bert as tbert

    return tbert.BertConfig(**{**tz.BERT_TINY, **over}, dtype=torch.float32,
                            scan_layers=scan_layers)


def bert_init(scan_layers=True, **over):
    """The JAX init as the port's state dict."""
    import jax

    from deepspeed_tpu_torch.module_inject.jax_params import \
        bert_state_dict_from_jax

    return bert_state_dict_from_jax(
        jax.device_get(jax_bert(scan_layers, **over)[1]),
        port_cfg(scan_layers, **over))


def jax_engine(ds, scan_layers=True, dp=1, fsdp=1):
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.parallel.mesh import MeshTopology

    jmodel, params = jax_bert(scan_layers)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=dp, fsdp=fsdp,
                              devices=jax.devices()[:dp * fsdp]))
    return jeng


def jax_run(ds, steps, scan_layers=True, dp=1, fsdp=1):
    """The JAX engine's losses and final parameters (port names)."""
    import jax

    from deepspeed_tpu_torch.module_inject.jax_params import \
        bert_state_dict_from_jax

    jeng = jax_engine(ds, scan_layers, dp, fsdp)
    losses = [float(jeng.train_batch(iter(step))) for step in steps]
    return {"losses": np.array(losses),
            "params": bert_state_dict_from_jax(jax.device_get(jeng.params),
                                               port_cfg(scan_layers))}


def _key_third_out(name, t):
    t = t.reshape(-1).float()
    if name.endswith("attention.qkv.bias"):
        return torch.cat([t[:C], t[2 * C:]])
    return t


def rel_l2_of_updates(got, want, start):
    """Relative L2 of ``got``'s updates against ``want``'s, the key third
    of every ``attention.qkv.bias`` left out."""
    diff = upd = 0.0
    for name, w in want.items():
        g, w, s = (_key_third_out(name, x) for x in (got[name], w,
                                                       start[name]))
        diff += float(((g - w) ** 2).sum())
        upd += float(((w - s) ** 2).sum())
    return (diff / upd) ** 0.5


def assert_updates_close(got, want, start, k=tz.K):
    for name, w in want.items():
        if name.endswith("attention.qkv.bias"):
            torch.testing.assert_close(got[name][C:2 * C].float(),
                                       w[C:2 * C].float(), rtol=0,
                                       atol=k * 2 * tz.LR, msg=name)
    assert rel_l2_of_updates(got, want, start) <= tz.UPDATE_REL_L2


# ---------------------------------------------------------------------------
# the options at ZeRO 0-3, and stage 3 against JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def start():
    depths = {over.get("num_hidden_layers", tz.BERT_TINY["num_hidden_layers"])
              for over, _ in OPTIONS.values()}
    out = {("layers", n): bert_init(num_hidden_layers=n) for n in depths}
    out["unscanned"] = bert_init(False)
    return out


def _init(start, option):
    return start[("layers", OPTIONS[option][0].get(
        "num_hidden_layers", tz.BERT_TINY["num_hidden_layers"]))]


@pytest.fixture(scope="module")
def runs(start, tmp_path_factory):
    """Every 2-rank case of the options and of stage 3: one spawn."""
    jobs = [tz.job(f"s{stage}_{name}", tz.config(stage, **blocks), STEPS,
                   init=_init(start, name), bert=True, model=over,
                   record_masks=1)
            for stage in STAGES for name, (over, blocks) in OPTIONS.items()]
    init = start[("layers", tz.BERT_TINY["num_hidden_layers"])]
    jobs += [tz.job(f"s3_jax{'_remat' if remat else ''}", STAGE3,
                    STEPS, init=init, bert=True, model={"remat": remat},
                    units=True)
             for remat in (False, True)]
    return tz.start_ranks(jobs, tmp_path_factory.mktemp("bert_dp"))


@pytest.fixture(scope="module")
def references(start):
    """The group-less engine on the global micro batches themselves."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert as tbert

    out = {}
    for name, (over, blocks) in OPTIONS.items():
        engine = deepspeed_tpu_torch.initialize(
            model=tbert.BertForPreTraining(port_cfg(**over)),
            config=tz.config(1, micro=tz.MICRO * tz.WORLD, **blocks),
            device="cpu",
            model_parameters={k: v.clone()
                              for k, v in _init(start, name).items()})[0]
        losses = [float(engine.train_batch(iter(s))) for s in STEPS]
        out[name] = {"losses": np.array(losses),
                     "norm": engine.get_global_grad_norm(),
                     "params": {k: v.clone() for k, v in
                                engine.module.state_dict().items()}}
    return out


@pytest.mark.parametrize("stage,option", [
    (stage, option) for stage in STAGES for option in OPTIONS])
def test_bert_option_under_a_group_matches_the_groupless_engine(
        stage, option, runs, references, start):
    name = f"s{stage}_{option}"
    tz.assert_ranks_agree(runs, name)
    got, ref = runs[0][name], references[option]
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=tz.LOSS_RTOL)
    np.testing.assert_allclose(got["norms"][-1], ref["norm"],
                               rtol=tz.LOSS_RTOL)
    assert_updates_close(got["params"], ref["params"], _init(start, option))


@pytest.mark.parametrize("stage", STAGES)
def test_bert_dropout_masks_differ_across_ranks(stage, runs):
    """Each rank keeps its own rows of the global draw: at the first site
    (the embedding's dropout, [2, 32, 32] per rank) the masks differ."""
    a, b = (r[f"s{stage}_dropout"]["masks"][0] for r in runs)
    assert a.shape == b.shape == (tz.MICRO, tz.SEQ, C)
    assert not torch.equal(a, b)
    assert abs(float(torch.cat([a, b]).float().mean()) - 0.9) < 0.03


@pytest.fixture(scope="module")
def jax_stage3():
    return jax_run(STAGE3, STEPS, fsdp=tz.WORLD)


@pytest.mark.parametrize("remat", [False, True])
def test_bert_stage3_matches_jax(remat, runs, start, jax_stage3):
    """Stage 3 over the layers' units against the JAX engine on a 2-device
    fsdp mesh (remat changes no value on either side; JAX's without it)."""
    name = f"s3_jax{'_remat' if remat else ''}"
    tz.assert_ranks_agree(runs, name)
    want = jax_stage3
    got = runs[0][name]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tz.LOSS_RTOL)
    assert_updates_close(got["params"], want["params"],
                         start[("layers", tz.BERT_TINY["num_hidden_layers"])])
    # the units: each layer's leaves, and the rest in the outer unit
    units = got["units"]
    assert sorted(units) == ["encoder.layer.0", "encoder.layer.1", "outer"]
    for i in range(tz.BERT_TINY["num_hidden_layers"]):
        assert units[f"encoder.layer.{i}"] and all(
            n.startswith(f"encoder.layer.{i}.")
            for n in units[f"encoder.layer.{i}"])
    assert "word_embeddings.weight" in units["outer"]
    assert not any(n.startswith("encoder.") for n in units["outer"])


# ---------------------------------------------------------------------------
# the int8 and 1-bit exchanges over the BERT layout
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_onebit():
    """The JAX 1-bit Adam engine one step at a time: the losses, and the
    state before and after each step (port names; each rank's optimizer
    state)."""
    import jax

    from deepspeed_tpu_torch.module_inject.jax_params import (
        bert_state_dict_from_jax, compressed_state_from_jax)

    cfg = port_cfg()
    jeng = jax_engine(ONEBIT, dp=tz.WORLD)

    def snapshot():
        opt = jax.device_get(jeng._opt_state)
        return {"params": bert_state_dict_from_jax(
                    jax.device_get(jeng.params), cfg),
                "opt": {r: compressed_state_from_jax(opt, cfg, "onebit", r,
                                                     tz.WORLD)
                        for r in range(tz.WORLD)}}

    losses, after = [], []
    for step in ONEBIT_STEPS:
        losses.append(float(jeng.train_batch(iter(step))))
        after.append(snapshot())
    return losses, after


@pytest.fixture(scope="module")
def gx_runs(start, jax_onebit, tmp_path_factory):
    """Every exchange case over the BERT: one spawn."""
    jobs = [tz.job(name, ds, GX_STEPS,
                   init=start[("layers", 2)] if scan else start["unscanned"],
                   bert=True, model={"scan_layers": scan})
            for name, (ds, scan) in INT8.items()]
    _, after = jax_onebit
    jobs.append(tz.job("onebit", ONEBIT, ONEBIT_STEPS[:1],
                       init=start[("layers", 2)], bert=True))
    jobs.append(tz.job("onebit_forced", ONEBIT, ONEBIT_STEPS[1:],
                       init=start[("layers", 2)], bert=True,
                       forced=after[:-1]))
    return tgx.run_ranks(jobs, tmp_path_factory.mktemp("bert_gx"))


@pytest.mark.parametrize("name", sorted(INT8))
def test_bert_int8_exchange_matches_jax(name, gx_runs, start):
    """The int8 exchange over the BERT's JAX layout (per leaf, scanned and
    unscanned, and bucketed) against the JAX engine in the same mode."""
    ds, scan = INT8[name]
    tgx.assert_ranks_agree(gx_runs, name)
    got = gx_runs[0][name]
    assert got["mode"] == "int8"
    want = jax_run(ds, GX_STEPS, scan_layers=scan, dp=tz.WORLD)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tz.LOSS_RTOL)
    assert_updates_close(got["params"], want["params"],
                         start[("layers", 2)] if scan else start["unscanned"],
                         k=len(got["losses"]))


def test_bert_onebit_adam_each_step_matches_jax(gx_runs, jax_onebit, start):
    """1-bit Adam over the BERT (``freeze_step`` 2: two exact warm-up
    steps, then two compressed), each step from the JAX engine's state
    before it: the loss, and the parameters' updates but for the key third
    of ``attention.qkv.bias``."""
    losses, after = jax_onebit
    for rank in range(tz.WORLD):
        first, rest = gx_runs[rank]["onebit"], gx_runs[rank]["onebit_forced"]
        assert first["mode"] == "onebit"
        got = [(first["losses"][0], first["params"])] + [
            (loss, s["params"]) for loss, s in zip(rest["losses"],
                                                   rest["forced"])]
        before = [start[("layers", 2)]] + [a["params"] for a in after[:-1]]
        for i, (loss, params) in enumerate(got):
            np.testing.assert_allclose(loss, losses[i], rtol=tz.LOSS_RTOL)
            err = rel_l2_of_updates(params, after[i]["params"], before[i])
            assert err <= tz.UPDATE_REL_L2, (rank, i, err)
