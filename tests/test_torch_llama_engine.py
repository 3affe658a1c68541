"""The LLaMA-shaped GPT through the port's engines, against the JAX
package's: serving (``init_inference``: logits, greedy decode from
left-padded prompts), training at ZeRO 1 (``initialize`` ->
``train_batch``), ZeRO stage 3 on 2 gloo ranks against the one-process
engine, and a checkpoint resume.

The config and size are ``test_torch_llama.py``'s (``llama_from_hf``'s
fields: RMSNorm, gated SiLU MLP, no biases, rotary, no position table,
grouped-query attention, an untied head; width 256, 4 query heads of dim
64, 2 layers, vocab 512), in f32. The bounds are those of the GPT-2 tests
of each engine: logits to atol 1e-4 (``test_torch_inference.py``), losses
to 1e-5 relative and parameters through their updates to 1e-3 in relative
L2 (``test_torch_zero.py``); greedy tokens and a resume are exact.
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
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import (adam_state_from_jax,
                                                           gpt_state_dict_from_jax)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402
import test_torch_zero as tz  # noqa: E402
from test_torch_llama import LLAMA  # noqa: E402

torch.set_num_threads(2)

ATOL = 1e-4
SERVE = dict(LLAMA, n_positions=64)


def _jax_params(fields, seed=0):
    jmodel = jlm.GPT(jlm.GPTConfig(**fields, dtype=jnp.float32))
    params = cached_init(jmodel, seed, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    return jmodel, params


@pytest.fixture(scope="module", params=[2, 1], ids=["gqa2", "mqa"])
def engines(request):
    fields = dict(SERVE, n_kv_head=request.param)
    jeng = deepspeed_tpu.init_inference(
        jlm.GPT(jlm.GPTConfig(**fields, dtype=jnp.float32)), dtype="fp32")
    ids = np.random.RandomState(0).randint(0, 512, size=(3, 12))
    jlogits = np.asarray(jeng(jnp.asarray(ids, jnp.int32)))
    cfg = tlm.GPTConfig(**fields, dtype=torch.float32)
    teng = deepspeed_tpu_torch.init_inference(
        tlm.GPT(cfg), dtype="fp32", device="cpu",
        state_dict=gpt_state_dict_from_jax(jax.device_get(jeng.params), cfg))
    return jeng, teng, ids, jlogits


def test_forward_matches_jax(engines):
    _, teng, ids, jlogits = engines
    got = teng(ids)
    assert got.shape == (3, 12, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jlogits, atol=ATOL, rtol=0)


@pytest.mark.parametrize("ragged", [False, True])
def test_greedy_generate_is_token_identical(engines, ragged):
    """Right-padded prompts of lengths 12, 7 and 3 are left-aligned by both
    engines; the rotary phases are the cache slots, pads included, in
    both."""
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
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    cache = teng._decoders[3].cache
    assert tuple(cache.key[0].shape) == (3, 64, teng.module.config.kv_heads,
                                         64)
    assert cache.position is None


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
LR = 1e-3
SEQ = 128


def _train_config(**over):
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "FusedAdam",
                        "params": {"lr": LR, "betas": [0.9, 0.95],
                                   "weight_decay": 0.1}},
          "zero_optimization": {"stage": 1},
          "tpu": {"use_pallas_optimizer": True},
          "steps_per_print": 10 ** 9}
    ds.update(over)
    return ds


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, LLAMA["vocab_size"], size=(n, 2, SEQ)).astype(np.int32)
    return [{"input_ids": x, "labels": x} for x in ids]


@pytest.mark.parametrize("case", ["einsum", "flash_remat"])
def test_zero1_training_matches_jax(case):
    """2 steps of the GPT-2 pretrain JSON's shape (FusedAdam on the fused
    kernel's plain version, ZeRO 1, clip 1.0) on both engines."""
    model = dict(LLAMA, use_flash_attention=case != "einsum",
                 remat=case != "einsum")
    jmodel = jlm.GPT(jlm.GPTConfig(**model, dtype=jnp.float32))
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    ds = _train_config()
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=1, devices=jax.devices()[:1]))
    tcfg = tlm.GPTConfig(**model, dtype=torch.float32)
    start = gpt_state_dict_from_jax(jax.device_get(params), tcfg)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tcfg), config=ds, device="cpu",
        model_parameters={k: v.clone() for k, v in start.items()})
    batches = _batches(1) * 2  # one batch twice: the loss must fall
    jl, tl, jn, tn = [], [], [], []
    for b in batches:
        jl.append(float(jeng.train_batch(iter([b]))))
        tl.append(float(teng.train_batch(iter([b]))))
        jn.append(jeng.get_global_grad_norm())
        tn.append(teng.get_global_grad_norm())
    np.testing.assert_allclose(tl, jl, rtol=tz.LOSS_RTOL)
    assert jl[1] < jl[0]
    # the first step's grad norm; the second's follows the update, where
    # Adam turns rounding noise in near-zero gradients into steps of lr
    # (test_torch_engine.py), and is held through the parameters below
    np.testing.assert_allclose(tn[0], jn[0], rtol=1e-5)
    want = gpt_state_dict_from_jax(jax.device_get(jeng.params), tcfg)
    tz.assert_updates_close(teng.module.state_dict(), want, start, k=2)
    # the JAX engine's Adam moments carry over leaf for leaf (c_gate,
    # lm_head, the RMSNorm scales; no biases, no wpe)
    moments = adam_state_from_jax(jax.device_get(jeng._opt_state), tcfg)
    assert moments["count"] == 2
    named = dict(teng.module.named_parameters())
    assert set(moments["state"]) == set(named)
    for name, st in moments["state"].items():
        assert st["mu"].shape == st["nu"].shape == named[name].shape, name


# ---------------------------------------------------------------------------
# ZeRO stages 2 and 3 on 2 gloo ranks
# ---------------------------------------------------------------------------
STAGE3_MODEL = {k: v for k, v in LLAMA.items() if k != "dropout"}
# (stage, stage3_param_persistence_threshold)
GROUP_CASES = {"s2": (2, None), "s3t0": (3, 0), "s3t100000": (3, 100_000)}


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    """Every 2-rank case, in one spawn, and the group-less reference."""
    _, params = _jax_params(STAGE3_MODEL)
    cfg = tlm.GPTConfig(**STAGE3_MODEL, dtype=torch.float32)
    init = gpt_state_dict_from_jax(jax.device_get(params), cfg)
    jobs = []
    for name, (stage, threshold) in GROUP_CASES.items():
        ds = (tz.config(stage) if threshold is None else tz.config(
            3, zero_optimization={
                "stage": 3, "stage3_param_persistence_threshold": threshold}))
        jobs.append(tz.job(name, ds, tz.MATRIX_STEPS[1], init=init,
                           model=STAGE3_MODEL, units=stage == 3))
    # the ranks run while the parent runs the one-process engine
    ranks = tz.start_ranks(jobs, tmp_path_factory.mktemp("llama_zero"))
    ref = tz.one_process(tz.config(0, 2), tz.MATRIX_STEPS[1], init,
                         model=STAGE3_MODEL)
    return ranks, ref, init


@pytest.mark.parametrize("name", sorted(GROUP_CASES))
def test_group_matches_one_process(name, group_runs):
    """Stage 2, and stage 3 at thresholds 0 (every leaf partitioned) and
    100,000 (the norms stay whole), at world 2 against the group-less
    engine at gas 2. At stage 3 the untied head is a leaf of the outer
    unit, beside ``wte`` (and ``ln_f`` when it is partitioned)."""
    ranks, ref, init = group_runs
    tz.assert_ranks_agree(ranks, name)
    got = ranks[0][name]
    np.testing.assert_allclose(got["losses"], ref["losses"],
                               rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(got["params"], ref["params"], init)
    stage, threshold = GROUP_CASES[name]
    if stage == 3:
        outer = set(got["units"]["outer"])
        want = {"wte.weight", "lm_head"} | (
            {"ln_f.weight"} if threshold == 0 else set())
        assert outer == want
        assert got["module_numels"]["lm_head"] == 0  # a placeholder


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def test_checkpoint_resume_is_bit_identical(tmp_path):
    """Save after 2 steps; 2 more steps of the saving engine against 2 of a
    fresh engine (another seed's weights) that loads the tag: losses and
    parameters bit for bit."""
    model = dict(LLAMA, lm_head_bias=True)
    ds = _train_config()
    batches = _batches(4, seed=2)

    def engine(seed):
        return deepspeed_tpu_torch.initialize(
            model=tlm.GPT(tlm.GPTConfig(**model, dtype=torch.float32)),
            config=ds, device="cpu", seed=seed)[0]

    a = engine(0)
    for b in batches[:2]:
        a.train_batch(iter([b]))
    a.save_checkpoint(str(tmp_path))
    la = [float(a.train_batch(iter([b]))) for b in batches[2:]]
    b_eng = engine(1)
    b_eng.load_checkpoint(str(tmp_path))
    lb = [float(b_eng.train_batch(iter([b]))) for b in batches[2:]]
    assert la == lb
    pa, pb = a.module.state_dict(), b_eng.module.state_dict()
    assert "lm_head" in pa and "lm_head_bias" in pa and "wpe.weight" not in pa
    for name, t in pa.items():
        assert torch.equal(t, pb[name]), name


@pytest.mark.parametrize("entry", ["init_inference", "initialize"])
def test_entry_points_default_to_the_card(entry):
    """Without ``device`` both entry points take ``"cuda"``, and raise here
    where torch sees no card, for the LLaMA-shaped model too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    model = tlm.GPT(tlm.GPTConfig(**LLAMA))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "init_inference":
            deepspeed_tpu_torch.init_inference(model, dtype="bf16")
        else:
            deepspeed_tpu_torch.initialize(model=model,
                                           config=_train_config())
