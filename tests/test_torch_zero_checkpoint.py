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
the async (``nebula``) engine writes a valid tag at world 2. The JAX
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
    dirs = {k: str(tmp / k) for k in ("world2", "one_card", "async")}
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
