"""The port's training engine against the JAX package's.

Both engines start from the same weights (the JAX init, carried over by
``gpt_state_dict_from_jax``), read the same DeepSpeed JSON and take the same
numpy batches; the JAX engine runs on one CPU device. Losses agree to the
order of sums (f32, 1e-5 relative). Parameters after K steps are held to
2e-5 absolute: Adam divides by sqrt(v), so a gradient entry near zero turns
f32 rounding differences into update differences of up to lr (1e-3); 2e-5 is
2% of one such step. The key part of ``c_attn.bias`` is the exception: its
gradient is zero in exact arithmetic (softmax ignores a per-row shift), both
sides hold only rounding noise there, and Adam normalizes that noise to
steps of +-lr, so it is held to K * 2 * lr.
"""

import os
import re
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
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu.runtime.dataloader import \
    DeepSpeedDataLoader as JaxDeepSpeedDataLoader
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax
from deepspeed_tpu_torch.ops.cuda import fused_adam as fadam
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=128, n_embd=64, n_layer=2, n_head=2)
LR = 1e-3
K = 3
# benchmarks/gpt_pretrain.py:51-61 with the script's CLI micro batch (:92)
GPT_PRETRAIN = {
    "train_micro_batch_size_per_gpu": 4,
    "gradient_accumulation_steps": 1,
    "bf16": {"enabled": True},
    "gradient_clipping": 1.0,
    "optimizer": {"type": "FusedAdam",
                  "params": {"lr": 2e-4, "betas": [0.9, 0.95],
                             "weight_decay": 0.1}},
    "zero_optimization": {"stage": 1},
    "steps_per_print": 10 ** 9,
    "tpu": {"use_pallas_optimizer": True},
}


def _config(**over):
    ds = {"train_micro_batch_size_per_gpu": 2,
          "optimizer": {"type": "FusedAdam",
                        "params": {"lr": LR, "betas": [0.9, 0.95],
                                   "weight_decay": 0.1}},
          "steps_per_print": 10 ** 9}
    ds.update(over)
    return ds


def _batches(n, t=128, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, SMALL["vocab_size"], size=(2, t)).astype(np.int32)
        out.append({"input_ids": ids, "labels": ids})
    return out


def _train_both(ds, *, flash=False, dtype="f32", gas=1):
    """K train_batch steps on each engine; returns both engines and their
    losses."""
    jdt = {"f32": jnp.float32, "f16": jnp.float16}[dtype]
    tdt = {"f32": torch.float32, "f16": torch.float16}[dtype]
    batches = _batches(K * gas)
    jmodel = jlm.GPT(jlm.GPTConfig(**SMALL, dtype=jdt, use_flash_attention=flash))
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=1, devices=jax.devices()[:1]))
    tcfg = tlm.GPTConfig(**SMALL, dtype=tdt, use_flash_attention=flash)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tcfg), config=ds, device="cpu",
        model_parameters=gpt_state_dict_from_jax(jax.device_get(params), tcfg))
    jl, tl = [], []
    for i in range(K):
        chunk = batches[i * gas:(i + 1) * gas]
        jl.append(float(jeng.train_batch(iter(chunk))))
        tl.append(float(teng.train_batch(iter(chunk))))
    return jeng, teng, np.array(jl), np.array(tl)


def _assert_params_close(jeng, teng):
    want = gpt_state_dict_from_jax(jax.device_get(jeng.params),
                                   teng.module.config)
    got = teng.module.state_dict()
    C = SMALL["n_embd"]
    for name, w in want.items():
        g = got[name].float()
        if name.endswith("attn.c_attn.bias"):
            key = slice(C, 2 * C)
            torch.testing.assert_close(g[key], w[key], rtol=0,
                                       atol=K * 2 * LR, msg=name)
            g, w = torch.cat([g[:C], g[2 * C:]]), torch.cat([w[:C], w[2 * C:]])
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5, msg=name)


@pytest.mark.parametrize("case", ["adamw", "fused_kernel", "flash_fused_kernel",
                                  "gas2_clip", "warmup_lr"])
def test_training_matches_jax(case):
    over, kw = {}, {}
    if "fused_kernel" in case:
        over["tpu"] = {"use_pallas_optimizer": True}
    if case.startswith("flash"):
        kw["flash"] = True
    if case == "gas2_clip":
        over.update(gradient_accumulation_steps=2, gradient_clipping=0.05)
        kw["gas"] = 2
    if case == "warmup_lr":
        over["scheduler"] = {"type": "WarmupLR", "params": {
            "warmup_min_lr": 0.0, "warmup_max_lr": LR, "warmup_num_steps": 3}}
    fadam.launches = 0
    jeng, teng, jl, tl = _train_both(_config(**over), **kw)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert type(teng.optimizer).__name__ == (
        "FusedAdamW" if "fused_kernel" in case else "AdamW")
    assert fadam.launches == 0, "a CPU tensor must not count as a kernel launch"
    assert teng.global_steps == jeng.global_steps == K
    assert teng.micro_steps == jeng.micro_steps
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               jeng.get_global_grad_norm(), rtol=1e-5)
    if case == "gas2_clip":
        assert jeng.get_global_grad_norm() > 0.05, "the clip must bite"
    if case == "warmup_lr":
        np.testing.assert_allclose(teng.get_lr(), jeng.get_lr(), rtol=1e-6)
    _assert_params_close(jeng, teng)


def test_fp16_overflow_skips_and_halves_the_scale():
    """fp16 compute with dynamic loss scaling from 2^20 (hysteresis 1): the
    first two steps overflow in both engines, are skipped and halve the
    scale; the third updates. Losses are held to 1e-3 relative (fp16
    rounds at different points on the two sides)."""
    ds = _config(fp16={"enabled": True, "initial_scale_power": 20,
                       "hysteresis": 1})
    jeng, teng, jl, tl = _train_both(ds, dtype="f16")
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert teng.skipped_steps == jeng.skipped_steps == 2
    assert teng.loss_scale == float(jeng.loss_scale) == 2.0 ** 18
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               jeng.get_global_grad_norm(), rtol=1e-3)
    assert teng.optimizer.count == 1


def test_fp16_overflow_with_accumulation_matches_jax():
    """The same fp16 overflow sequence at gas 2: each micro step's
    gradients of ``loss * scale / 2`` are summed in f32 and the skip and
    the scale update happen at the boundary, in both engines."""
    ds = _config(gradient_accumulation_steps=2,
                 fp16={"enabled": True, "initial_scale_power": 20,
                       "hysteresis": 1})
    jeng, teng, jl, tl = _train_both(ds, dtype="f16", gas=2)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    # the halved micro losses overflow once: 2^20 -> 2^19, then two updates
    assert teng.skipped_steps == jeng.skipped_steps == 1
    assert teng.loss_scale == float(jeng.loss_scale) == 2.0 ** 19
    assert teng.micro_steps == jeng.micro_steps == 2 * K
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               jeng.get_global_grad_norm(), rtol=1e-3)
    assert teng.optimizer.count == K - 1


def test_gpt_pretrain_config_parses_as_in_jax():
    t, j = DeepSpeedConfig(GPT_PRETRAIN), JaxDeepSpeedConfig(GPT_PRETRAIN)
    t._resolve_batch_triad(1)
    j._resolve_batch_triad(1)
    for attr in ("train_batch_size", "train_micro_batch_size_per_gpu",
                 "gradient_accumulation_steps", "gradient_clipping",
                 "steps_per_print", "precision_dtype"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.zero_config.stage == j.zero_config.stage == 1
    assert t.optimizer.to_dict() == j.optimizer.to_dict()
    assert t.tpu.use_pallas_optimizer and j.tpu.use_pallas_optimizer
    assert t.unported_features() == []


# data_pipeline and curriculum_learning are ported (test_torch_data.py,
# test_torch_curriculum.py), progressive_layer_drop and activation
# checkpointing too (test_torch_stochastic_depth.py,
# test_torch_remat_policies.py): other refusals take their places
@pytest.mark.parametrize("block", [
    {"step_profiler": {"enabled": True}},
    {"sentinel": {"enabled": True}},
    {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}},
    {"tensorboard": {"enabled": True}},
    {"wandb": {"enabled": True}},
    {"eigenvalue": {"enabled": True}},
    # tp and ep are ported (test_torch_tensor_parallel.py,
    # test_torch_expert_parallel.py); sp stays refused (ROADMAP A.9 part 2)
    {"tpu": {"mesh": {"sp": 2}}},
    {"activation_checkpointing": {"cpu_checkpointing": True}},
    {"flops_profiler": {"enabled": True}},
    {"graceful_shutdown": {"enabled": True, "save_dir": "ckpt"}},
])
def test_enabled_unported_block_raises(block):
    cfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        deepspeed_tpu_torch.initialize(model=tlm.GPT(cfg),
                                       config=_config(**block), device="cpu")


def test_amp_block_is_inert_as_in_jax():
    """The JAX config parses ``amp`` for compatibility and reads it nowhere
    (``deepspeed_tpu/runtime/config.py:57-59, 806``): a JSON with it
    initialises both engines, which train the same first step."""
    ds = _config(amp={"enabled": True, "opt_level": "O1"})
    assert DeepSpeedConfig(ds).unported_features() == []
    jeng, teng, jl, tl = _train_both(ds)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_params_close(jeng, teng)


def test_every_refusal_names_its_roadmap_item():
    """Every block ``unported_features`` refuses, all enabled at once, is
    named with the ROADMAP item that ports it."""
    ds = _config(
        sentinel={"enabled": True}, step_profiler={"enabled": True},
        flops_profiler={"enabled": True}, tensorboard={"enabled": True},
        wandb={"enabled": True}, csv_monitor={"enabled": True},
        graceful_shutdown={"enabled": True, "save_dir": "ckpt"},
        pipeline={"stages": 2}, eigenvalue={"enabled": True},
        compression_training={"weight_quantization": {}},
        quantize_training={"enabled": True},
        activation_checkpointing={"cpu_checkpointing": True},
        checkpoint={"load_universal": True},
        zero_optimization={"stage": 2,
                           "offload_optimizer": {"device": "cpu"},
                           "offload_param": {"device": "cpu"}},
        tpu={"mesh": {"sp": 2}, "step_autotune": {"enabled": True},
             "cluster_health": {"enabled": True}})
    names = DeepSpeedConfig(ds).unported_features()
    assert len(names) == 18, names
    for name in names:
        assert re.search(r"ROADMAP A\.(9|1[0-2])\b", name), name


def test_exchange_modes_without_a_group():
    """The gradient exchanges are ported (``test_torch_grad_exchange.py``):
    without a process group the deferred exchange has no dp axis to defer
    over and is inert, as in the JAX engine at dp 1, and the int8 and 1-bit
    exchanges ask for a group; ``hierarchical: on`` without the deferred
    exchange raises the JAX engine's error."""
    cfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(cfg), device="cpu",
        config=_config(tpu={"grad_exchange": {"deferred": True}}))[0]
    assert engine._cx is None
    for block in ({"optimizer": {"type": "OneBitAdam", "params": {}}},
                  {"communication_data_type": "int8"}):
        with pytest.raises(ValueError, match="init_distributed"):
            deepspeed_tpu_torch.initialize(model=tlm.GPT(cfg), device="cpu",
                                           config=_config(**block))
    with pytest.raises(ValueError, match="hierarchical: on requires"):
        deepspeed_tpu_torch.initialize(
            model=tlm.GPT(cfg), device="cpu",
            config=_config(tpu={"grad_exchange": {"hierarchical": "on"}}))


def test_initialize_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(
            model=tlm.GPT(tlm.GPTConfig(**SMALL)), config=_config())


def test_unported_engine_paths_raise():
    """A client optimizer is the one engine path still refused (set_lr,
    save_checkpoint and load_checkpoint are ported:
    ``test_torch_optimizers.py``, ``test_torch_checkpoint.py``)."""
    cfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="client optimizer"):
        deepspeed_tpu_torch.initialize(model=tlm.GPT(cfg), config=_config(),
                                       optimizer=object(), device="cpu")


def test_eval_batch_and_padded_loader_match_jax():
    """A ragged dataset with dataloader_drop_last=False: both loaders pad
    the tail and add an attention_mask (so the batch leaves the flash
    path), and eval_batch on a fresh engine gives the JAX loss."""
    rng = np.random.RandomState(7)
    data = [{"input_ids": x, "labels": x}
            for x in rng.randint(0, 128, size=(5, 32)).astype(np.int32)]
    tb = list(DeepSpeedDataLoader(data, batch_size=2, drop_last=False))
    jb = list(JaxDeepSpeedDataLoader(data, batch_size=2, drop_last=False))
    assert len(tb) == len(jb) == 3
    for a, b in zip(tb, jb):
        assert set(a) == set(b) == {"input_ids", "labels", "attention_mask"}
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    jmodel = jlm.GPT(jlm.GPTConfig(**SMALL, dtype=jnp.float32))
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    want = jmodel.apply({"params": params},
                        **{k: jnp.asarray(v) for k, v in tb[-1].items()})
    tcfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tcfg), config=_config(), device="cpu",
        model_parameters=gpt_state_dict_from_jax(jax.device_get(params), tcfg))
    got = engine.eval_batch(next(RepeatingLoader(tb[-1:])))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_package_exports_match_jax(tmp_path):
    """``initialize``, ``DeepSpeedConfig`` and ``add_config_arguments`` at
    the package root, as in ``deepspeed_tpu``; a JSON path parses as the
    dict does."""
    import argparse
    import json

    assert deepspeed_tpu_torch.DeepSpeedConfig is DeepSpeedConfig
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(GPT_PRETRAIN))
    assert DeepSpeedConfig(str(path)).optimizer.to_dict() == \
        DeepSpeedConfig(GPT_PRETRAIN).optimizer.to_dict()
    args = ["--deepspeed", "--deepspeed_config", str(path)]
    got = deepspeed_tpu_torch.add_config_arguments(
        argparse.ArgumentParser()).parse_args(args)
    want = deepspeed_tpu.add_config_arguments(
        argparse.ArgumentParser()).parse_args(args)
    assert vars(got) == vars(want)


# the tiny BERT of tests/unit/test_sparse_attention.py:148-171, two layers
BERT_TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=64)
BIGBIRD_16 = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
              "num_sliding_window_blocks": 3, "num_global_blocks": 1}


def _mlm_batches(n, seed=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, BERT_TINY["vocab_size"], size=(2, 64)).astype(np.int32)
        labels = np.where(rng.rand(2, 64) < 0.15, ids, -100).astype(np.int32)
        labels[:, 0] = ids[:, 0]
        out.append({"input_ids": ids, "labels": labels})
    return out


@pytest.mark.parametrize("kernel", ["pallas", "gather"])
def test_bert_bigbird_training_matches_jax(kernel):
    """BERT with the BigBird block from the config alone, 3 steps on each
    engine from the same weights: the port's engine rebuilds the model with
    block-sparse attention as the JAX engine does, and losses and
    parameters agree as in the GPT cases ("pallas" runs the plain B5-B7
    path here and the Pallas kernels in interpret mode on the JAX side)."""
    from deepspeed_tpu.models import bert as jbert
    from deepspeed_tpu_torch.models import bert as tbert
    from deepspeed_tpu_torch.module_inject.jax_params import bert_state_dict_from_jax
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa

    ds = _config(gradient_clipping=1.0, tpu={"use_pallas_optimizer": True},
                 sparse_attention=dict(BIGBIRD_16, kernel=kernel))
    jmodel = jbert.BertForPreTraining(jbert.BertConfig(
        **BERT_TINY, dtype=jnp.float32, param_dtype=jnp.float32))
    params = cached_init(jmodel, 0, jnp.zeros((1, 64), jnp.int32))["params"]
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=1, devices=jax.devices()[:1]))
    tcfg = tbert.BertConfig(**BERT_TINY, dtype=torch.float32)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=tbert.BertForPreTraining(tcfg), config=ds, device="cpu",
        model_parameters=bert_state_dict_from_jax(jax.device_get(params), tcfg))
    sc = teng.module.config.sparse_attention
    assert type(sc).__name__ == "BigBirdSparsityConfig" and sc.kernel_impl == kernel
    assert type(jeng.module.config.sparse_attention).__name__ == type(sc).__name__
    bsa.launches_sparse_fwd = 0
    batches = _mlm_batches(K)
    jl = [float(jeng.train_batch(iter([b]))) for b in batches]
    tl = [float(teng.train_batch(iter([b]))) for b in batches]
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert bsa.launches_sparse_fwd == 0, "a CPU tensor must not count as a launch"
    np.testing.assert_allclose(teng.get_global_grad_norm(),
                               jeng.get_global_grad_norm(), rtol=1e-5)
    want = bert_state_dict_from_jax(jax.device_get(jeng.params), tcfg)
    got = teng.module.state_dict()
    C = BERT_TINY["hidden_size"]
    for name, w in want.items():
        g = got[name].float()
        if name.endswith("attention.qkv.bias"):
            # the key part's gradient is zero in exact arithmetic (see the
            # module docstring)
            torch.testing.assert_close(g[C:2 * C], w[C:2 * C], rtol=0,
                                       atol=K * 2 * LR, msg=name)
            g, w = torch.cat([g[:C], g[2 * C:]]), torch.cat([w[:C], w[2 * C:]])
        torch.testing.assert_close(g, w, rtol=0, atol=2e-5, msg=name)


def test_bert_dense_mode_matches_full_attention():
    """mode=dense reproduces full attention: the same first-step loss as a
    config with no sparse_attention block (the JAX test of the same name)."""
    from deepspeed_tpu_torch.models import bert as tbert

    tcfg = tbert.BertConfig(**BERT_TINY, dtype=torch.float32)
    batch = _mlm_batches(1)[0]
    losses = []
    for over in ({}, {"sparse_attention": {"mode": "dense", "block": 16}}):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=tbert.BertForPreTraining(tcfg), config=_config(**over),
            device="cpu", seed=4)
        losses.append(float(engine.train_batch(iter([batch]))))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_gpt_with_a_sparse_attention_block_raises():
    """A GPT takes the block-sparse route from a ``sparse_attention`` block
    (``test_torch_sparse_gpt.py`` holds it to the JAX package); what the JAX
    attention refuses there, a packed batch, the port refuses with its
    words."""
    cfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(cfg), device="cpu",
        config=_config(sparse_attention=dict(BIGBIRD_16, kernel="pallas")))[0]
    assert engine.module.config.sparse_attention.kernel_impl == "pallas"
    ids = np.zeros((2, 64), np.int64)
    seg = np.ones_like(ids)
    with pytest.raises(NotImplementedError,
                       match="segment_ids with a block-sparse layout"):
        engine.train_batch(iter([{"input_ids": ids, "labels": ids,
                                  "segment_ids": seg}]))
