"""The port's curriculum (``deepspeed_tpu_torch/runtime/data_pipeline/``)
against the JAX package's: the scheduler's difficulty at every step under
the four schedule types, the truncation, and the engine's packing length
(``_PackingLength``) against the difficulty the JAX engine's pipeline reads
without prefetch. All exact: integers on both sides. The engine under a
curriculum without the data pipeline (a plain loader's batches truncated)
holds the JAX engine's losses to 1e-5 relative (``test_torch_engine.py``'s
tolerance: f32, the order of sums).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.runtime.data_pipeline import (
    CurriculumScheduler, truncate_batch_to_difficulty)

SCHEDULES = {
    "fixed_linear": {"min_difficulty": 8, "max_difficulty": 1024,
                     "schedule_type": "fixed_linear",
                     "schedule_config": {"total_curriculum_step": 30,
                                         "difficulty_step": 8}},
    "fixed_linear_coarse": {"min_difficulty": 256, "max_difficulty": 1024,
                            "schedule_type": "fixed_linear",
                            "schedule_config": {"total_curriculum_step": 12,
                                                "difficulty_step": 256}},
    "fixed_root": {"min_difficulty": 64, "max_difficulty": 512,
                   "schedule_type": "fixed_root",
                   "schedule_config": {"total_curriculum_step": 25,
                                       "difficulty_step": 16,
                                       "root_degree": 3}},
    "fixed_discrete": {"min_difficulty": 1, "max_difficulty": 100,
                       "schedule_type": "fixed_discrete",
                       "schedule_config": {"difficulty": [16, 48, 100],
                                           "max_step": [5, 17]}},
    "custom": {"schedule_type": "custom"},
}


def _custom(step):
    return 32 + 16 * (step % 5)


def schedulers(name):
    from deepspeed_tpu.runtime.data_pipeline import \
        CurriculumScheduler as JaxScheduler

    cfg = dict(SCHEDULES[name], enabled=True, curriculum_type="seqlen")
    out = (CurriculumScheduler(cfg), JaxScheduler(cfg))
    if name == "custom":
        for s in out:
            s.set_custom_get_difficulty(_custom)
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_difficulty_matches_jax(name):
    mine, ref = schedulers(name)
    got = [mine.get_difficulty(s) for s in range(41)]
    assert got == [ref.get_difficulty(s) for s in range(41)]
    assert [mine.update_difficulty(s) for s in range(41)] == got
    ref.update_difficulty(40)
    assert mine.state_dict() == ref.state_dict() == {
        "current_difficulty": got[-1]}
    assert len(set(got)) > 1
    if name != "custom":
        cfg = SCHEDULES[name]
        assert min(got) >= cfg["min_difficulty"]
        assert max(got) == cfg["max_difficulty"]


def test_scheduler_errors_and_state_match_jax():
    from deepspeed_tpu.runtime.data_pipeline import \
        CurriculumScheduler as JaxScheduler

    for bad in ({"schedule_type": "fixed_linear", "schedule_config": {}},
                {"schedule_type": "fixed_discrete",
                 "schedule_config": {"difficulty": [1, 2], "max_step": []}}):
        for S in (CurriculumScheduler, JaxScheduler):
            with pytest.raises(ValueError):
                S(bad)
    for S in (CurriculumScheduler, JaxScheduler):
        with pytest.raises(ValueError, match="custom"):
            S({"schedule_type": "custom"}).get_difficulty(0)
    mine, ref = schedulers("fixed_root")
    mine.update_difficulty(7)
    ref.update_difficulty(7)
    assert mine.state_dict() == ref.state_dict()
    fresh = CurriculumScheduler(dict(SCHEDULES["fixed_root"]))
    fresh.load_state_dict(ref.state_dict())
    assert fresh.get_current_difficulty() == ref.get_current_difficulty()


@pytest.mark.parametrize("seqlen", [8, 24, 64, 100])
def test_truncation_matches_jax(seqlen):
    from deepspeed_tpu.runtime.data_pipeline import \
        truncate_batch_to_difficulty as jax_truncate

    rng = np.random.RandomState(seqlen)
    batch = {"input_ids": rng.randint(0, 50, (3, 64)).astype(np.int32),
             "segment_ids": rng.randint(0, 3, (3, 64)).astype(np.int32),
             "scalar_per_row": rng.randn(3).astype(np.float32),
             "emb": rng.randn(3, 64, 2).astype(np.float32)}
    got, want = (truncate_batch_to_difficulty(batch, seqlen),
                 jax_truncate(batch, seqlen))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    # tensors on the card's side take the same cut
    tensors = truncate_batch_to_difficulty(
        {k: torch.from_numpy(v) for k, v in batch.items()}, seqlen)
    for k in want:
        np.testing.assert_array_equal(tensors[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("gas", [1, 2, 3])
@pytest.mark.parametrize("name", ["fixed_linear", "fixed_discrete", "custom"])
def test_packing_length_is_what_the_jax_pipeline_reads(name, gas):
    """The JAX engine's pipeline reads ``sched.current_difficulty`` as it
    draws each batch; without prefetch batch n is drawn before micro step
    n updates the difficulty. ``_PackingLength`` gives the same sequence
    from the batch index alone, and from any batch a resume starts at."""
    from deepspeed_tpu_torch.runtime.engine import _PackingLength

    mine, ref = schedulers(name)
    want = []
    global_steps = 0
    for n in range(40):
        want.append(ref.current_difficulty)    # the pipeline draws batch n
        ref.update_difficulty(global_steps + 1)  # micro step n (forward)
        if (n + 1) % gas == 0:
            global_steps += 1
    length = _PackingLength(mine, gas, 0)
    assert [length() for _ in range(40)] == want
    for start in (gas, 4 * gas):
        resumed = _PackingLength(schedulers(name)[0], gas, 0)
        resumed.restart(start)
        assert [resumed() for _ in range(40 - start)] == want[start:]


def test_engine_curriculum_without_the_pipeline_matches_jax():
    """``curriculum_learning`` alone: each batch of a plain loader is
    truncated to the step's difficulty, in the port as in the JAX engine
    (losses 1e-5 relative; three distinct lengths over the 6 steps)."""
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu
    import deepspeed_tpu_torch
    from deepspeed_tpu.models import transformer_lm as jlm
    from deepspeed_tpu.parallel.mesh import MeshTopology
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    small = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2,
                 n_head=2)
    ds = {"train_micro_batch_size_per_gpu": 2,
          "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
          "curriculum_learning": {
              "enabled": True, "curriculum_type": "seqlen",
              "min_difficulty": 16, "max_difficulty": 64,
              "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 4,
                                  "difficulty_step": 16}},
          "steps_per_print": 10 ** 9}
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(6):
        ids = rng.randint(0, 128, size=(2, 64)).astype(np.int32)
        batches.append({"input_ids": ids, "labels": ids})
    jmodel = jlm.GPT(jlm.GPTConfig(**small, dtype=jnp.float32))
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    jeng = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=1, devices=jax.devices()[:1]))[0]
    tcfg = tlm.GPTConfig(**small, dtype=torch.float32)
    teng = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tcfg), config=ds, device="cpu",
        model_parameters=gpt_state_dict_from_jax(jax.device_get(params),
                                                 tcfg))[0]
    jl = [float(jeng.train_batch(iter([b]))) for b in batches]
    tl, lengths = [], []
    for b in batches:
        tl.append(float(teng.train_batch(iter([b]))))
        lengths.append(teng.curriculum_scheduler.get_current_difficulty())
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert lengths == [16, 32, 48, 64, 64, 64]
