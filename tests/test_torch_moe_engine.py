"""Mixture-of-experts GPTs through the port's engines, against the JAX
package's: serving at the eval capacity (``init_inference``), training
(``initialize`` -> ``train_batch``) on one process and at ZeRO stages 0-2
on 2 gloo ranks, the engine's gating noise, and checkpoints with one file
per expert.

The JAX engine hands its MoE layers a ``gating`` key in every training
step, which top-1 gating uses only for RSample noise and random token
selection; with both off (``moe_use_rts=False``, no noise policy) both
engines route deterministically, and their runs are compared. The model
is ``test_torch_zero.py``'s small GPT (width 64, 2 heads, 2 layers, vocab
128) with 4 experts, in f32; the bounds are that file's: losses to 1e-5
relative, parameters through their updates to 1e-3 in relative L2 (Adam
turns rounding noise in near-zero gradients into steps of lr), the first
step's grad norm to 1e-5; logits to atol 1e-4, greedy tokens and resumes
exact. With noise on, two engines from one seed draw the same noise and a
resume restores the generator: the runs are compared bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime import checkpoint_manifest as jcm
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.runtime.dataloader import RepeatingLoader

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402
import test_torch_zero as tz  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4
# top-1 without noise or RTS: deterministic in both engines
SWITCH = dict(moe_num_experts=4, moe_top_k=1, moe_use_rts=False,
              moe_capacity_factor=1.0, moe_eval_capacity_factor=2.0,
              moe_aux_loss_coef=0.01)
# Mixtral's gated experts and top-2 (noise in training)
TOP2 = dict(moe_num_experts=4, moe_top_k=2, moe_gated_experts=True,
            moe_capacity_factor=1.0, moe_eval_capacity_factor=2.0)
# top-1 with both draws: RSample noise and random token selection, at a
# capacity that drops tokens
NOISY = dict(moe_num_experts=4, moe_top_k=1,
             moe_noisy_gate_policy="RSample", moe_capacity_factor=0.5)


def _fields(moe, **over):
    """``test_torch_zero.py``'s small GPT with experts, 128 positions."""
    return {**tz.SMALL, "n_positions": 128, **moe, **over}


def _jax_params(fields, seed=0):
    jmodel = jlm.GPT(jlm.GPTConfig(**fields, dtype=jnp.float32))
    params = cached_init(jmodel, seed, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    return jmodel, params


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["switch", "top2"])
def engines(request):
    fields = _fields(SWITCH if request.param == "switch" else TOP2)
    jeng = deepspeed_tpu.init_inference(
        jlm.GPT(jlm.GPTConfig(**fields, dtype=jnp.float32)), dtype="fp32")
    ids = np.random.RandomState(0).randint(0, 128, size=(3, 12))
    jlogits = np.asarray(jeng(jnp.asarray(ids, jnp.int32)))
    cfg = tlm.GPTConfig(**fields, dtype=torch.float32)
    teng = deepspeed_tpu_torch.init_inference(
        tlm.GPT(cfg), dtype="fp32", device="cpu",
        state_dict=gpt_state_dict_from_jax(jax.device_get(jeng.params), cfg))
    return jeng, teng, ids, jlogits


def test_serving_forward_matches_jax(engines):
    _, teng, ids, jlogits = engines
    got = teng(ids)
    np.testing.assert_allclose(got.numpy(), jlogits, atol=ATOL, rtol=0)
    assert not teng.module.h[0].mlp.training  # the eval capacity


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_is_token_identical(engines, ragged):
    jeng, teng, ids, _ = engines
    mask = None
    if ragged:
        mask = np.arange(12)[None, :] < np.array([12, 7, 3])[:, None]
    want = np.asarray(jeng.generate(
        jnp.asarray(ids, jnp.int32), max_new_tokens=6,
        attention_mask=None if mask is None else jnp.asarray(mask)))
    got = teng.generate(ids, max_new_tokens=6,
                        attention_mask=None if mask is None
                        else torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_expert_parallel_serving_is_refused_naming_a9():
    """ep serves over a process group (test_torch_expert_parallel.py):
    without one ``ep_size`` > 1 raises naming ``init_distributed``. The
    scheduler's refusal of an ep engine (ROADMAP A.9 part 2) is lifted:
    rank 0 of the ep group leads it (test_torch_tp_serving.py)."""
    import types

    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.parallel.tensor import ParallelLayout

    with pytest.raises(ValueError, match="comm.init_distributed"):
        deepspeed_tpu_torch.init_inference(
            tlm.GPT(tlm.GPTConfig(**_fields(SWITCH))), dtype="fp32",
            device="cpu", ep_size=2)
    engine = types.SimpleNamespace(module=tlm.GPT(
        tlm.GPTConfig(**_fields(SWITCH)), parallel=ParallelLayout(ep=2)))
    assert ContinuousBatchingScheduler(engine).leader


# ---------------------------------------------------------------------------
# training on one process
# ---------------------------------------------------------------------------
SEQ = 128


def _config(**over):
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "FusedAdam",
                        "params": {"lr": tz.LR, "betas": [0.9, 0.95],
                                   "weight_decay": 0.1}},
          "zero_optimization": {"stage": 1},
          "tpu": {"use_pallas_optimizer": True},
          "steps_per_print": 10 ** 9}
    ds.update(over)
    return ds


def _batches(n, seed=1, rows=2):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, tz.SMALL["vocab_size"],
                      size=(n, rows, SEQ)).astype(np.int32)
    return [{"input_ids": x, "labels": x} for x in ids]


@pytest.mark.parametrize("case", ["einsum", "flash_remat", "gated"])
def test_training_matches_jax(case):
    """2 steps of ZeRO 1 with FusedAdam (its kernel's plain version) and
    clip 1.0 on both engines: the loss (cross entropy + aux), the first
    grad norm, the updates of every parameter (the gates' and experts'
    included) and the Adam moments' layout."""
    over = ({"use_flash_attention": True, "remat": True}
            if case == "flash_remat" else
            {"moe_gated_experts": True} if case == "gated" else {})
    fields = _fields(SWITCH, **over)
    jmodel, params = _jax_params(fields)
    ds = _config()
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=1, devices=jax.devices()[:1]))
    tcfg = tlm.GPTConfig(**fields, dtype=torch.float32)
    start = gpt_state_dict_from_jax(jax.device_get(params), tcfg)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tcfg), config=ds, device="cpu",
        model_parameters={k: v.clone() for k, v in start.items()})
    assert teng._gating_kinds == ()
    jl, tl, jn, tn = [], [], [], []
    for b in _batches(1) * 2:
        jl.append(float(jeng.train_batch(iter([b]))))
        tl.append(float(teng.train_batch(iter([b]))))
        jn.append(jeng.get_global_grad_norm())
        tn.append(teng.get_global_grad_norm())
    np.testing.assert_allclose(tl, jl, rtol=tz.LOSS_RTOL)
    assert jl[1] < jl[0]
    np.testing.assert_allclose(tn[0], jn[0], rtol=1e-5)
    want = gpt_state_dict_from_jax(jax.device_get(jeng.params), tcfg)
    tz.assert_updates_close(teng.module.state_dict(), want, start, k=2)
    gate = "h.0.mlp.gate.weight"
    assert not torch.equal(teng.module.state_dict()[gate], start[gate])


def _noisy_engine(seed, moe=NOISY, **over):
    return deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**_fields(moe, **over),
                                    dtype=torch.float32)),
        config=_config(), device="cpu", seed=seed)[0]


@pytest.mark.parametrize("moe", ["noisy", "top2"])
def test_gating_noise_is_drawn_fresh_each_step_and_from_the_seed(moe):
    """Each step draws new noise into the engine's buffer; two engines from
    one seed draw the same (so their losses agree bit for bit), and the
    noise changes the routing (another gating seed, other losses)."""
    moe = NOISY if moe == "noisy" else TOP2
    batches = _batches(3, seed=5)
    runs = []
    for seed in (3, 3):
        eng = _noisy_engine(seed, moe)
        it = iter(RepeatingLoader(batches))
        noise, losses = [], []
        for _ in range(3):
            losses.append(float(eng.train_batch(it)))
            noise.append(torch.cat([b.flatten() for b in
                                    eng._gating_noise.values()]).clone())
        runs.append((losses, noise))
    (la, na), (lb, nb) = runs
    assert la == lb
    assert all(torch.equal(x, y) for x, y in zip(na, nb))
    assert not torch.equal(na[0], na[1]) and not torch.equal(na[1], na[2])
    other = _noisy_engine(3, moe)
    other._gating_gen.manual_seed(12345)
    lo = float(other.train_batch(iter(RepeatingLoader(batches))))
    assert lo != la[0]


def test_checkpoint_per_expert_files_and_bit_identical_resume(tmp_path):
    """Save after 3 noisy steps: one model and one optimizer file per
    expert, listed in the manifest, which the JAX package's
    ``verify_tag_dir`` accepts; a fresh engine from another seed that
    loads the tag takes the next 3 steps bit for bit (the weights, Adam's
    moments and the gating generator restored)."""
    batches = _batches(4, seed=6)
    a = _noisy_engine(0, use_flash_attention=True, remat=True)
    it = iter(RepeatingLoader(batches))
    for _ in range(3):
        a.train_batch(it)
    a.save_checkpoint(str(tmp_path))
    tag_dir = str(tmp_path / "global_step3")
    files = sorted(os.listdir(tag_dir))
    for e in range(4):
        for kind in ("model", "optim"):
            assert f"expert_{e}_mp_rank_00_{kind}_states.pt" in files
    assert jcm.verify_tag_dir(tag_dir) == []
    manifest = jcm.read_manifest(tag_dir)
    assert "expert_3_mp_rank_00_optim_states.pt" in manifest["files"]
    main = torch.load(os.path.join(tag_dir, "mp_rank_00_model_states.pt"),
                      weights_only=True)
    assert not any(".experts." in k for k in main["module"])
    assert main["moe_experts"]["counts"]["module/h.0.mlp.experts.wi"] == 4
    la = [float(a.train_batch(it)) for _ in range(3)]
    b = _noisy_engine(1, use_flash_attention=True, remat=True)
    b.load_checkpoint(str(tmp_path))
    it_b = iter(RepeatingLoader(batches))
    for _ in range(3):
        next(it_b)
    lb = [float(b.train_batch(it_b)) for _ in range(3)]
    assert la == lb
    pa, pb = a.module.state_dict(), b.module.state_dict()
    for name, t in pa.items():
        assert torch.equal(t, pb[name]), name
    # without the generator's state the resumed run routes otherwise
    c = _noisy_engine(1, use_flash_attention=True, remat=True)
    c.load_checkpoint(str(tmp_path))
    c._gating_gen.manual_seed(99)
    it_c = iter(RepeatingLoader(batches))
    for _ in range(3):
        next(it_c)
    assert float(c.train_batch(it_c)) != la[0]


def test_serving_from_a_moe_tag_equals_the_trained_model(tmp_path):
    """``init_inference(checkpoint=tag_dir)`` reads the model-states file
    with the experts merged back from their files."""
    a = _noisy_engine(0)
    a.train_batch(iter(_batches(1)))
    a.save_checkpoint(str(tmp_path))
    want = {k: v.clone() for k, v in a.module.state_dict().items()}
    served = deepspeed_tpu_torch.init_inference(
        tlm.GPT(tlm.GPTConfig(**_fields(NOISY), dtype=torch.float32)),
        dtype="fp32", device="cpu",
        checkpoint=str(tmp_path / "global_step1"))
    got = served.module.state_dict()
    assert set(got) == set(want)
    for name, t in want.items():
        assert torch.equal(got[name], t), name


# ---------------------------------------------------------------------------
# ZeRO stages 0-2 on 2 gloo ranks
# ---------------------------------------------------------------------------
GROUP_STAGES = (0, 1, 2)
# each rank routes its own rows, as the reference DeepSpeed does: its
# capacity and l_aux come from its tokens. Under GSPMD the JAX layer sees
# the global batch (ROADMAP C), so against JAX no token may drop (factor 4:
# capacity = the tokens) and the aux loss is left out
SWITCH_GLOBAL = dict(SWITCH, moe_capacity_factor=4.0, moe_aux_loss_coef=0.0)


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    """Stages 0-2 (with drops and the aux loss, and without them), a refused
    stage 3 and a noisy run in one 2-rank spawn; the JAX engine on a
    2-device fsdp mesh and the group-less port engine."""
    inits = {}
    for key, model in (("local", SWITCH), ("global", SWITCH_GLOBAL)):
        _, params = tz.jax_init(**model)
        cfg = tlm.GPTConfig(**_fields(model), dtype=torch.float32)
        inits[key] = gpt_state_dict_from_jax(jax.device_get(params), cfg)
    steps = tz.MATRIX_STEPS[1]
    jobs = []
    for stage in GROUP_STAGES:
        jobs.append(tz.job(f"s{stage}", tz.config(stage), steps,
                           init=inits["local"], model=SWITCH))
        jobs.append(tz.job(f"j{stage}", tz.config(stage), steps,
                           init=inits["global"], model=SWITCH_GLOBAL))
    jobs.append(tz.job("s3", tz.config(3), steps, init=inits["local"],
                       model=SWITCH, raises=True))
    jobs.append(tz.job("s1_noisy", tz.config(1), [steps[0]] * 3,
                       model=dict(NOISY), seed=4))
    # the ranks run while the parent runs JAX and the one-process engine
    ranks = tz.start_ranks(jobs, tmp_path_factory.mktemp("moe_zero"))
    jax_by_stage = {stage: tz.jax_run(tz.config(stage), steps,
                                      model=SWITCH_GLOBAL)
                    for stage in GROUP_STAGES}
    refs = {stage: tz.one_process(tz.config(stage, 2), steps,
                                  inits["local"], model=SWITCH)
            for stage in GROUP_STAGES}
    return ranks, jax_by_stage, refs, inits


@pytest.mark.parametrize("stage", GROUP_STAGES)
def test_zero_at_world_2_matches_one_process(stage, group_runs):
    """The expert leaves are plain replicated parameters in the flat
    buffers (ep = 1): each stage, with tokens dropped and the aux loss on,
    against the group-less engine at gas 2 over the same rows (one rank's
    rows per micro batch: the same routing)."""
    ranks, _, refs, inits = group_runs
    name = f"s{stage}"
    tz.assert_ranks_agree(ranks, name)
    got, ref = ranks[0][name], refs[stage]
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(got["params"], ref["params"], inits["local"])


@pytest.mark.parametrize("stage", GROUP_STAGES)
def test_zero_at_world_2_matches_jax(stage, group_runs):
    """Each stage against the JAX engine on its 2-device fsdp mesh, where
    per-rank and global routing agree (no drop, no aux loss)."""
    ranks, jax_by_stage, _, inits = group_runs
    name = f"j{stage}"
    tz.assert_ranks_agree(ranks, name)
    got, want = ranks[0][name], jax_by_stage[stage]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(got["params"], want["params"], inits["global"])


def test_zero_stage_3_with_experts_is_refused_naming_a3(group_runs):
    ranks = group_runs[0]
    for r in ranks:
        kind, words = r["s3"]["error"]
        assert kind == "NotImplementedError" and "A.3" in words


def test_noisy_ranks_draw_the_global_batch_noise(group_runs):
    """With noise on, every rank draws the global micro batch's noise and
    keeps its rows' slice: the ranks stay in step (equal losses and
    parameters) and the loss falls."""
    ranks = group_runs[0]
    tz.assert_ranks_agree(ranks, "s1_noisy")
    losses = ranks[0]["s1_noisy"]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_gating_noise_slices_by_data_parallel_rank():
    """The noise a rank hands its model is its rows' slice of the global
    draw (the same generator on every rank)."""
    eng = _noisy_engine(0)
    eng.data_parallel_size = 2
    eng.topology = type("T", (), {"data_parallel_rank": lambda self: 1})()
    batch = {"input_ids": torch.zeros((2, SEQ), dtype=torch.long)}
    gen_state = eng._gating_gen.get_state()
    mine = eng._gating(batch)["gating_noise"]
    eng._gating_gen.set_state(gen_state)
    buf = next(iter(eng._gating_noise.values()))
    whole = torch.empty_like(buf)
    from deepspeed_tpu_torch.moe import draw_gating_noise

    draw_gating_noise(whole, eng._gating_kinds, eng._gating_gen)
    local = 2 * SEQ
    assert torch.equal(mine, whole[:, :, local:2 * local])
