"""Checkpoints of the data-parallel engine: one tag format at every world.

2 gloo ranks (the worker of ``test_torch_zero.py``, one spawn for the
file) train a small f32 GPT at ZeRO stage 1 for 4 steps and save after the
second (rank 0 gathers the optimizer's shards and writes the whole tensors
by parameter name). The tag then resumes:

* at world 2 and stage 1: the resumed steps repeat the uninterrupted run's
  bit for bit (losses and parameters);
* at world 2 and stage 2, and on one process with no group: within the
  tolerances of ``test_torch_zero.py`` (losses 1e-5 relative, the updates
  since the save to 1e-3 in relative L2), each load logged as a reshard.

A tag saved by the one-process engine resumes at world 2 the same way, and
the async (``nebula``) engine writes a valid tag at world 2. At ZeRO stage
3 (threshold 5000: partitioned and whole leaves) a tag at world 2 resumes
exactly at stage 3, within the tolerances at stage 1 and on one process,
and a stage-1 tag resumes at stage 3; ``engine.params``,
``save_16bit_model`` and ``GatheredParameters`` give whole tensors under
the original names, and ``eval_batch`` matches stage 0's. The JAX
package's ``verify_tag_dir`` accepts the tags, and its
``layout.topology_matches`` reads their topology block and reports the
world change.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_zero as tz  # noqa: E402

STEPS = tz.global_batches(4, 1, seed=5)
TAG = "global_step2"
STAGE3 = tz.config(3, zero_optimization={
    "stage": 3, "stage3_param_persistence_threshold": 5000})
# a partitioned leaf of a block, one of the outer unit, and a whole one
GATHERED = ["h.1.mlp.c_fc.weight", "wte.weight", "h.0.ln_1.bias"]


def _one_card(micro, init):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    return deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**tz.SMALL, dtype=torch.float32)),
        config=tz.config(1, micro=micro), device="cpu",
        model_parameters={k: v.clone() for k, v in init.items()})[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank jobs, and a tag of the one-process engine they load."""
    import jax

    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    init = gpt_state_dict_from_jax(jax.device_get(tz.jax_init()[1]),
                                   tlm.GPTConfig(**tz.SMALL,
                                                 dtype=torch.float32))
    tmp = tmp_path_factory.mktemp("zero_ckpt")
    dirs = {k: str(tmp / k) for k in ("world2", "one_card", "async",
                                      "world2_s3", "sixteen")}
    # the one-process engine's tag (the global micro batch in one micro
    # batch of 4 rows), and its run on from there
    one = _one_card(tz.MICRO * tz.WORLD, init)
    for step in STEPS[:2]:
        one.train_batch(iter(step))
    one.save_checkpoint(dirs["one_card"])
    one_losses = [float(one.train_batch(iter(s))) for s in STEPS[2:]]
    one_params = {k: v.clone() for k, v in one.module.state_dict().items()}
    jobs = [
        tz.job("run", tz.config(1), STEPS, init=init,
               save={"dir": dirs["world2"], "after": 2}),
        tz.job("same", tz.config(1), STEPS[2:], load=dirs["world2"]),
        tz.job("stage2", tz.config(2), STEPS[2:], load=dirs["world2"]),
        tz.job("from_one_card", tz.config(1), STEPS[2:],
               load=dirs["one_card"]),
        tz.job("async", tz.config(2, nebula={"enabled": True}), STEPS[:1],
               init=init, save={"dir": dirs["async"], "after": 1}),
        tz.job("run3", STAGE3, STEPS, init=init,
               save={"dir": dirs["world2_s3"], "after": 2},
               save16=dirs["sixteen"], gathered=GATHERED),
        tz.job("s3_same", STAGE3, STEPS[2:], load=dirs["world2_s3"]),
        tz.job("s3_to_s1", tz.config(1), STEPS[2:], load=dirs["world2_s3"]),
        tz.job("s1_to_s3", STAGE3, STEPS[2:], load=dirs["world2"]),
        tz.job("eval0", tz.config(0), [], init=init, eval=STEPS[0][0]),
        tz.job("eval3", STAGE3, [], init=init, eval=STEPS[0][0]),
    ]
    (tmp / "spawn").mkdir()
    per_rank = tz.run_ranks(jobs, tmp / "spawn")
    return {"ranks": per_rank, "dirs": dirs, "init": init,
            "one_losses": np.array(one_losses), "one_params": one_params}


def test_resume_at_the_same_world_and_stage_is_exact(runs):
    for r in runs["ranks"]:
        run, same = r["run"], r["same"]
        assert same["tag"] == TAG and same["reshard"] == []
        assert same["losses"] == run["losses"][2:]
        for k, v in run["params"].items():
            assert torch.equal(same["params"][k], v), k


def test_resume_at_stage_2(runs):
    for r in runs["ranks"]:
        run, got = r["run"], r["stage2"]
        assert got["reshard"] == ["zero_stage 1 -> 2"]
        np.testing.assert_allclose(got["losses"], run["losses"][2:],
                                   rtol=tz.LOSS_RTOL)
        tz.assert_updates_close(got["params"], run["params"],
                                r["same"]["initial"], k=2)


def test_resume_on_one_process(runs):
    """The world-2 tag in an engine with no process group, which takes
    the global micro batch as one micro batch of 4 rows."""
    run = runs["ranks"][0]["run"]
    engine = _one_card(tz.MICRO * tz.WORLD, runs["init"])
    tag, _ = engine.load_checkpoint(runs["dirs"]["world2"])
    assert tag == TAG
    assert engine.last_reshard.mismatches == ["world_size 2 -> 1",
                                              "fsdp 2 -> 1"]
    losses = [float(engine.train_batch(iter(s))) for s in STEPS[2:]]
    np.testing.assert_allclose(losses, run["losses"][2:], rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(engine.module.state_dict(), run["params"],
                            runs["ranks"][0]["same"]["initial"], k=2)
    assert engine.optimizer.count == 4 and engine.global_steps == 4


def test_one_process_tag_resumes_at_world_2(runs):
    for r in runs["ranks"]:
        got = r["from_one_card"]
        assert got["reshard"] == ["world_size 1 -> 2", "fsdp 1 -> 2"]
        np.testing.assert_allclose(got["losses"], runs["one_losses"],
                                   rtol=tz.LOSS_RTOL)
        tz.assert_updates_close(got["params"], runs["one_params"],
                                got["initial"], k=2)


@pytest.mark.parametrize("which,tag", [("world2", TAG),
                                       ("async", "global_step1")])
def test_jax_package_reads_the_tag(runs, which, tag):
    import jax

    from deepspeed_tpu.parallel.mesh import MeshTopology
    from deepspeed_tpu.runtime import checkpoint_manifest as jcm
    from deepspeed_tpu.runtime import layout as jlayout

    tag_dir = os.path.join(runs["dirs"][which], tag)
    assert jcm.verify_tag_dir(tag_dir) == []
    assert jcm.read_latest(runs["dirs"][which]) == tag
    block = jcm.read_manifest(tag_dir)["topology"]
    assert block["world_size"] == 2
    assert block["axis_sizes"]["fsdp"] == 2
    one = MeshTopology(dp=1, devices=jax.devices()[:1])
    assert jlayout.topology_matches(block, one, block["zero_stage"]) == [
        "world_size 2 -> 1", "fsdp 2 -> 1"]


def test_tag_holds_whole_tensors_by_name(runs):
    """Rank 0 wrote each parameter's moments whole, by its name, as the
    one-process engine does."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine import (
        OPTIM_STATES, load_torch_file)

    sd = load_torch_file(os.path.join(runs["dirs"]["world2"], TAG,
                                      OPTIM_STATES))["optimizer"]
    params = runs["ranks"][0]["run"]["params"]
    assert sd["count"] == 2
    assert sorted(sd["state"]) == sorted(params)
    for name, p in params.items():
        assert set(sd["state"][name]) == {"mu", "nu"}
        assert sd["state"][name]["mu"].shape == p.shape
        assert float(sd["state"][name]["nu"].abs().sum()) > 0


def test_stage3_resume_at_the_same_world_and_stage_is_exact(runs):
    for r in runs["ranks"]:
        run, same = r["run3"], r["s3_same"]
        assert same["tag"] == TAG and same["reshard"] == []
        assert same["losses"] == run["losses"][2:]
        for k, v in run["params"].items():
            assert torch.equal(same["params"][k], v), k


def test_stage3_tag_resumes_at_stage_1(runs):
    for r in runs["ranks"]:
        run, got = r["run3"], r["s3_to_s1"]
        assert got["reshard"] == ["zero_stage 3 -> 1"]
        np.testing.assert_allclose(got["losses"], run["losses"][2:],
                                   rtol=tz.LOSS_RTOL)
        tz.assert_updates_close(got["params"], run["params"],
                                r["s3_same"]["initial"], k=2)


def test_stage3_tag_resumes_on_one_process(runs):
    run = runs["ranks"][0]["run3"]
    engine = _one_card(tz.MICRO * tz.WORLD, runs["init"])
    tag, _ = engine.load_checkpoint(runs["dirs"]["world2_s3"])
    assert tag == TAG
    assert engine.last_reshard.mismatches == [
        "world_size 2 -> 1", "fsdp 2 -> 1", "zero_stage 3 -> 1"]
    losses = [float(engine.train_batch(iter(s))) for s in STEPS[2:]]
    np.testing.assert_allclose(losses, run["losses"][2:], rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(engine.module.state_dict(), run["params"],
                            runs["ranks"][0]["s3_same"]["initial"], k=2)


def test_stage1_tag_resumes_at_stage_3(runs):
    for r in runs["ranks"]:
        run, got = r["run"], r["s1_to_s3"]
        assert got["reshard"] == ["zero_stage 1 -> 3"]
        np.testing.assert_allclose(got["losses"], run["losses"][2:],
                                   rtol=tz.LOSS_RTOL)
        tz.assert_updates_close(got["params"], run["params"],
                                r["same"]["initial"], k=2)


def test_stage3_gives_whole_tensors_by_name(runs):
    """``engine.params``, the tag's model file, ``save_16bit_model`` and
    ``GatheredParameters`` hold every parameter whole under its name, with
    the values the engine trained."""
    from deepspeed_tpu_torch.runtime.checkpoint_engine import (
        MODEL_STATES, load_torch_file)

    a, b = (r["run3"] for r in runs["ranks"])
    shapes = {k: v.shape for k, v in runs["init"].items()}
    assert {k: v.shape for k, v in a["params"].items()} == shapes
    for k, v in a["params"].items():
        assert torch.equal(b["params"][k], v), k
    tag_sd = load_torch_file(os.path.join(runs["dirs"]["world2_s3"], TAG,
                                          MODEL_STATES))["module"]
    assert {k: v.shape for k, v in tag_sd.items()} == shapes
    sixteen = load_torch_file(os.path.join(runs["dirs"]["sixteen"],
                                           "pytorch_model.pt"))["module"]
    assert sixteen.keys() == shapes.keys()
    for k, v in a["params"].items():
        assert torch.equal(sixteen[k], v.to(torch.bfloat16)), k
    for r in runs["ranks"]:
        for name in GATHERED:
            assert torch.equal(r["run3"]["gathered"][name],
                               a["params"][name]), name


def test_eval_batch_at_stage_3_matches_stage_0(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["eval3"]["eval"], r["eval0"]["eval"],
                                   rtol=tz.LOSS_RTOL)
