"""The port's checkpoints against the JAX package's.

A small f32 GPT starts from the JAX init (carried over by
``gpt_state_dict_from_jax``) and takes the same numpy batches on both
sides; the JAX engine runs on one CPU device. Within the port a resume is
exact: the steps after a load repeat the steps after the save bit for bit.
Against the JAX engine, losses and grad norms agree to 1e-5 relative, the
tolerance of ``test_torch_engine.py``. Parameters are held through their
updates (trained minus initial weights) to 1e-3 in relative L2 norm, as
``chip_smoke.py``'s card-against-CPU check holds them: at this sequence
length a few weights get gradients near Adam's eps, where f32 rounding
differences become update differences of a good part of lr (one entry of
4096 in ``h.0.attn.c_proj.weight`` moves 1e-4), so a max-abs bound would
measure those entries alone. The key third of ``c_attn.bias`` is held
apart, to K * 2 * lr (its gradient is zero in exact arithmetic; see
``test_torch_engine.py``). The tag
directory the port writes passes the JAX package's own
``verify_tag_dir``; logits served from a checkpoint equal those of an
engine built from the same ``state_dict`` exactly, and the JAX forward of
the same weights to 1e-4 absolute (``test_torch_inference.py``'s bound).
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
from deepspeed_tpu.ops.pallas.fused_adam import FusedAdamWState
from deepspeed_tpu.parallel.mesh import MeshTopology
from deepspeed_tpu.runtime import checkpoint_manifest as jcm
from deepspeed_tpu.runtime import layout as jlayout
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JaxDeepSpeedConfig
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import (
    adam_state_from_jax, gpt_state_dict_from_jax)
from deepspeed_tpu_torch.runtime import checkpoint_engine as tce
from deepspeed_tpu_torch.runtime import checkpoint_manifest as tcm
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

torch.set_num_threads(2)

SMALL = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=2)
LR = 1e-3
MODEL_FILE = "mp_rank_00_model_states.pt"


def _config(**over):
    ds = {"train_micro_batch_size_per_gpu": 2, "gradient_clipping": 1.0,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": LR, "weight_decay": 0.1}},
          "steps_per_print": 10 ** 9}
    ds.update(over)
    return ds


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, SMALL["vocab_size"], size=(n, 2, 32)).astype(np.int32)
    return [{"input_ids": x, "labels": x} for x in ids]


BATCHES = _batches(4)


def _tcfg(dtype=torch.float32):
    return tlm.GPTConfig(**SMALL, dtype=dtype)


def _port(params=None, seed=0, config=None, dtype=torch.float32):
    sd = None if params is None else gpt_state_dict_from_jax(params, _tcfg())
    return deepspeed_tpu_torch.initialize(
        model=tlm.GPT(_tcfg(dtype)), config=config or _config(),
        device="cpu", model_parameters=sd, seed=seed)[0]


def _steps(engine, batches):
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch(iter([b]))))
        norms.append(engine.get_global_grad_norm())
    return np.array(losses), np.array(norms)


def _params(engine):
    return {k: v.clone() for k, v in engine.module.state_dict().items()}


def _assert_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


UPDATE_REL_L2 = 1e-3


def _assert_close_to_jax(jparams, got, start, k):
    """Port parameters against a JAX tree, ``k`` steps after the JAX tree
    ``start``: the updates to 1e-3 in relative L2 norm."""
    want = gpt_state_dict_from_jax(jparams, _tcfg())
    w0 = gpt_state_dict_from_jax(start, _tcfg())
    C = SMALL["n_embd"]
    diff_sq = upd_sq = 0.0
    for name, w in want.items():
        g, s = got[name].float(), w0[name]
        if name.endswith("attn.c_attn.bias"):
            torch.testing.assert_close(g[C:2 * C], w[C:2 * C], rtol=0,
                                       atol=k * 2 * LR, msg=name)
            g, w, s = (torch.cat([x[:C], x[2 * C:]]) for x in (g, w, s))
        diff_sq += float(((g - w) ** 2).sum())
        upd_sq += float(((w - s) ** 2).sum())
    assert (diff_sq / upd_sq) ** 0.5 <= UPDATE_REL_L2


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine: 2 steps, save, 2 steps (run 1), load, the same 2
    steps (run 2); and the state after the first 2 steps."""
    jmodel = jlm.GPT(jlm.GPTConfig(**SMALL, dtype=jnp.float32))
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=_config(), model_parameters=params,
        topology=MeshTopology(dp=1, devices=jax.devices()[:1]))
    out = {"model": jmodel, "params0": jax.device_get(params)}
    out["first"] = _steps(jeng, BATCHES[:2])
    out["after2"] = (jax.device_get(jeng.params),
                     jax.device_get(jeng._opt_state))
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jeng.save_checkpoint(d)
    out["run1"] = _steps(jeng, BATCHES[2:])
    out["run1_params"] = jax.device_get(jeng.params)
    jeng.load_checkpoint(d)
    out["run2"] = _steps(jeng, BATCHES[2:])
    return out


def test_checkpoint_resume_training_identical(jax_run, tmp_path):
    """Train 2, save, train 2 (run 1), load, train 2 (run 2), in both
    packages: the port's run 2 equals its run 1 exactly, and its run 1
    matches the JAX engine's."""
    engine = _port(jax_run["params0"])
    first = _steps(engine, BATCHES[:2])
    engine.save_checkpoint(str(tmp_path))
    run1 = _steps(engine, BATCHES[2:])
    params1 = _params(engine)
    tag, _ = engine.load_checkpoint(str(tmp_path))
    run2 = _steps(engine, BATCHES[2:])
    assert tag == "global_step2" and engine.global_steps == 4
    np.testing.assert_array_equal(run2[0], run1[0])
    np.testing.assert_array_equal(run2[1], run1[1])
    _assert_equal(_params(engine), params1)
    for got, want in ((first, jax_run["first"]), (run1, jax_run["run1"]),
                      (run2, jax_run["run2"])):
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    _assert_close_to_jax(jax_run["run1_params"], params1,
                         jax_run["params0"], 4)


def test_resume_from_jax_trained_state(jax_run):
    """The JAX engine's parameters and Adam state after 2 steps, carried
    by ``gpt_state_dict_from_jax`` and ``adam_state_from_jax``: the port
    takes the next 2 steps as the JAX engine did."""
    jparams, jstate = jax_run["after2"]
    engine = _port(jparams)
    sd = adam_state_from_jax(jstate, _tcfg())
    assert sd["count"] == 2 and set(sd["state"]) == set(engine.optimizer.names)
    engine.optimizer.load_state_dict(sd)
    losses, norms = _steps(engine, BATCHES[2:])
    np.testing.assert_allclose(losses, jax_run["run1"][0], rtol=1e-5)
    np.testing.assert_allclose(norms, jax_run["run1"][1], rtol=1e-5)
    _assert_close_to_jax(jax_run["run1_params"], _params(engine), jparams, 2)


def test_adam_state_from_jax_reads_the_fused_adamw_state(jax_run):
    """The Pallas optimizer's ``FusedAdamWState`` converts as optax's
    ``ScaleByAdamState`` does (the same count, mu and nu)."""
    _, jstate = jax_run["after2"]
    want = adam_state_from_jax(jstate, _tcfg())
    inner = [s for s in jstate if hasattr(s, "mu")][0]
    got = adam_state_from_jax(
        FusedAdamWState(count=inner.count, mu=inner.mu, nu=inner.nu), _tcfg())
    assert got["count"] == want["count"]
    for name, entry in want["state"].items():
        for key in ("mu", "nu"):
            assert torch.equal(got["state"][name][key], entry[key])


@pytest.mark.parametrize("gas", [1, 2])
def test_checkpoint_roundtrip(tmp_path, gas):
    """As the JAX ``test_checkpoint_roundtrip``: the tag is
    ``global_step{n}``, ``client_state`` comes back, the parameters are
    restored exactly, and an engine from another seed resumes
    identically. At gas 2 the load comes in the middle of an accumulation
    window, whose partial sums it drops."""
    config = _config(gradient_accumulation_steps=gas)
    batches = _batches(6 * gas, seed=2)
    engine = _port(seed=3, config=config)
    for i in range(2):
        engine.train_batch(iter(batches[i * gas:(i + 1) * gas]))
    engine.save_checkpoint(str(tmp_path), client_state={"note": "hello"})
    saved = _params(engine)
    after = batches[2 * gas:4 * gas]
    run1 = [float(engine.train_batch(iter(after[i * gas:(i + 1) * gas])))
            for i in range(2)]
    params1 = _params(engine)
    if gas == 2:
        engine.forward(batches[-1])  # half a window, then the load
    tag, client = engine.load_checkpoint(str(tmp_path))
    assert tag == "global_step2" and client == {"note": "hello"}
    assert engine.global_steps == 2 and engine.micro_steps == 2 * gas
    _assert_equal(_params(engine), saved)
    fresh = _port(seed=4, config=config)
    assert fresh.load_checkpoint(str(tmp_path))[0] == tag
    for eng in (engine, fresh):
        run = [float(eng.train_batch(iter(after[i * gas:(i + 1) * gas])))
               for i in range(2)]
        assert run == run1
        _assert_equal(_params(eng), params1)


def test_load_before_the_first_step(tmp_path):
    """The port holds its parameters from ``init``, so a load may come
    before any step (the JAX engine needs one first)."""
    engine = _port(seed=3)
    engine.train_batch(iter(BATCHES[:1]))
    engine.save_checkpoint(str(tmp_path))
    fresh = _port(seed=4)
    assert fresh.load_checkpoint(str(tmp_path))[0] == "global_step1"
    _assert_equal(_params(fresh), _params(engine))
    assert fresh.optimizer.count == 1


def test_fp16_loss_scale_and_skipped_steps_survive(tmp_path):
    """fp16 from a loss scale of 2^20 with hysteresis 2: the overflowed
    steps are skipped (the sequence ``test_torch_engine.py`` holds against
    the JAX engine); the loss-scale state and the skipped-step count come
    back in a fresh engine, whose next step equals the saving engine's."""
    config = _config(fp16={"enabled": True, "initial_scale_power": 20,
                           "hysteresis": 2})
    engine = _port(seed=3, config=config, dtype=torch.float16)
    for b in _batches(4, seed=5):
        engine.train_batch(iter([b]))
    state = [float(engine._ls_state.scale), int(engine._ls_state.good_steps),
             int(engine._ls_state.hysteresis)]
    assert engine.skipped_steps > 0 and state[0] < 2.0 ** 20
    engine.save_checkpoint(str(tmp_path))
    fresh = _port(seed=4, config=config, dtype=torch.float16)
    fresh.load_checkpoint(str(tmp_path))
    assert [float(fresh._ls_state.scale), int(fresh._ls_state.good_steps),
            int(fresh._ls_state.hysteresis)] == state
    assert fresh.skipped_steps == engine.skipped_steps
    assert fresh.optimizer.count == engine.optimizer.count
    nxt = _batches(1, seed=6)
    assert float(fresh.train_batch(iter(nxt))) == float(
        engine.train_batch(iter(nxt)))
    _assert_equal(_params(fresh), _params(engine))


# -- the manifest, against the JAX package's module ---------------------------
def test_port_tag_passes_the_jax_verification(tmp_path):
    engine = _port(seed=3)
    engine.train_batch(iter(BATCHES[:1]))
    engine.save_checkpoint(str(tmp_path))
    tag_dir = str(tmp_path / "global_step1")
    assert jcm.read_latest(str(tmp_path)) == "global_step1"
    assert jcm.verify_tag_dir(tag_dir) == [] == tcm.verify_tag_dir(tag_dir)
    manifest = jcm.read_manifest(tag_dir)
    assert manifest["version"] == jcm.MANIFEST_VERSION
    assert sorted(manifest["files"]) == [
        "engine_states.pt", MODEL_FILE,
        "zero_pp_rank_0_mp_rank_00_optim_states.pt"]
    for name, entry in manifest["files"].items():
        assert entry == jcm.file_digest(os.path.join(tag_dir, name))
    assert manifest["topology"] == jlayout.topology_metadata(
        MeshTopology(dp=1, devices=jax.devices()[:1]), engine.zero_stage)


def _damage(path, how):
    if how == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
    elif how == "bit_flip":
        with open(path, "r+b") as f:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0x01]))
    else:
        os.unlink(path)


@pytest.mark.parametrize("how,problem", [("truncated", "size mismatch"),
                                         ("bit_flip", "crc mismatch"),
                                         ("missing", "missing file")])
def test_verification_detects_damage(tmp_path, how, problem):
    """Truncation, a same-size bit flip and a missing file, each found by
    both packages' ``verify_tag_dir`` (as ``test_fault_tolerance.py``)."""
    engine = _port(seed=3)
    engine.save_checkpoint(str(tmp_path))
    tag_dir = str(tmp_path / "global_step0")
    _damage(os.path.join(tag_dir, MODEL_FILE), how)
    for cm in (tcm, jcm):
        problems = cm.verify_tag_dir(tag_dir)
        assert len(problems) == 1 and problem in problems[0], problems


def test_stream_digest_equals_the_file_digest(tmp_path):
    path = str(tmp_path / "t" / "x.pt")
    state = {"w": torch.randn(300, 7), "meta": {"n": 3}}
    digest, retries = tce.write_torch_file(state, path)
    assert retries == 0 and not os.path.exists(path + ".tmp")
    assert digest == jcm.file_digest(path) == tcm.file_digest(path)
    assert torch.equal(tce.load_torch_file(path)["w"], state["w"])


def test_keep_n_never_deletes_latest(tmp_path):
    engine = _port(seed=3, config=_config(checkpoint={"keep_n": 2}))
    tags = []
    for i in range(4):
        engine.train_batch(iter(BATCHES[i:i + 1]))
        engine.save_checkpoint(str(tmp_path))
        tags.append(f"global_step{engine.global_steps}")
        mpath = tcm.manifest_path(str(tmp_path / tags[-1]))
        os.utime(mpath, (1_000_000 + i,) * 2)  # ordered commit times
    remaining = sorted(d for d in os.listdir(tmp_path)
                       if (tmp_path / d).is_dir())
    assert remaining == sorted(tags[-2:])
    assert jcm.read_latest(str(tmp_path)) == tags[-1]
    assert not os.path.exists(tmp_path / "latest.tmp")


def test_corrupt_tag_falls_back_then_raises(tmp_path):
    """A tag that fails verification falls back to the newest valid one
    (as ``test_fault_tolerance.py:255``); with none left, the load raises
    (``:273``)."""
    engine = _port(seed=3)
    engine.train_batch(iter(BATCHES[:1]))
    engine.save_checkpoint(str(tmp_path))
    good = _params(engine)
    os.utime(tcm.manifest_path(str(tmp_path / "global_step1")),
             (1_000_000,) * 2)
    engine.train_batch(iter(BATCHES[1:2]))
    engine.save_checkpoint(str(tmp_path))
    _damage(str(tmp_path / "global_step2" / MODEL_FILE), "truncated")
    assert engine.load_checkpoint(str(tmp_path))[0] == "global_step1"
    assert engine.global_steps == 1
    _assert_equal(_params(engine), good)
    engine.train_batch(iter(BATCHES[2:3]))
    assert engine.global_steps == 2
    _damage(str(tmp_path / "global_step1" / MODEL_FILE), "bit_flip")
    with pytest.raises(RuntimeError, match="no previous valid tag"):
        engine.load_checkpoint(str(tmp_path), tag="global_step2")


def test_async_engine_saves_the_state_at_the_call(tmp_path):
    """``nebula`` selects the async engine: a parameter update between
    ``save`` and ``wait`` leaves the pre-update values on disk; a whole
    ``save_checkpoint`` then loads back."""
    engine = _port(seed=3, config=_config(nebula={"enabled": True}))
    assert isinstance(engine.checkpoint_engine, tce.AsyncCheckpointEngine)
    engine.train_batch(iter(BATCHES[:1]))
    before = _params(engine)
    path = str(tmp_path / "t" / "model.pt")
    engine.checkpoint_engine.save({"module": engine.module.state_dict()}, path)
    engine.train_batch(iter(BATCHES[1:2]))
    engine.checkpoint_engine.commit("t")
    _assert_equal(tce.load_torch_file(path)["module"], before)
    assert not torch.equal(before["wte.weight"], _params(engine)["wte.weight"])
    assert jcm.verify_tag_dir(str(tmp_path / "t")) == []
    engine.save_checkpoint(str(tmp_path / "c"))
    saved = _params(engine)
    engine.train_batch(iter(BATCHES[2:3]))
    assert engine.load_checkpoint(str(tmp_path / "c"))[0] == "global_step2"
    _assert_equal(_params(engine), saved)


def test_checkpoint_config_parses_as_in_jax():
    block = {"checkpoint": {"keep_n": 3, "verify": False,
                            "tag_validation": "fail"}}
    t, j = DeepSpeedConfig(_config(**block)), JaxDeepSpeedConfig(_config(**block))
    for attr in ("checkpoint_keep_n", "checkpoint_verify",
                 "checkpoint_tag_validation", "load_universal_checkpoint"):
        assert getattr(t, attr) == getattr(j, attr), attr
    for bad in ({"keep_n": -1}, {"tag_validation": "sometimes"}):
        with pytest.raises(Exception, match="checkpoint"):
            DeepSpeedConfig(_config(checkpoint=bad))
        with pytest.raises(Exception, match="checkpoint"):
            JaxDeepSpeedConfig(_config(checkpoint=bad))
    on = DeepSpeedConfig(_config(nebula={"enabled": True},
                                 wall_clock_breakdown=True))
    assert on.unported_features() == []
    with pytest.raises(NotImplementedError, match="A.12"):
        _port(config=_config(checkpoint={"load_universal": True}))


# -- serving from a checkpoint ------------------------------------------------
@pytest.mark.parametrize("source", ["model_states", "tag_dir", "16bit"])
def test_serve_from_checkpoint(jax_run, tmp_path, source):
    """``init_inference(checkpoint=...)`` from each kind of path: the
    logits equal those of an engine built from the same ``state_dict``
    exactly, and the JAX forward of the same weights (the JAX init, in
    bf16 for the 16-bit file) to 1e-4."""
    engine = _port(jax_run["params0"])
    engine.save_checkpoint(str(tmp_path))
    engine.save_16bit_model(str(tmp_path))
    sd, jparams = _params(engine), jax_run["params0"]
    if source == "16bit":
        sd = {k: v.to(torch.bfloat16) for k, v in sd.items()}
        jparams = jax.tree.map(
            lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32),
            jparams)
    path = {"model_states": tmp_path / "global_step0" / MODEL_FILE,
            "tag_dir": tmp_path / "global_step0",
            "16bit": tmp_path / "pytorch_model.pt"}[source]
    ids = np.random.RandomState(0).randint(0, SMALL["vocab_size"], size=(3, 12))
    got = deepspeed_tpu_torch.init_inference(
        tlm.GPT(_tcfg()), dtype="fp32", device="cpu", checkpoint=str(path))(ids)
    want = deepspeed_tpu_torch.init_inference(
        tlm.GPT(_tcfg()), dtype="fp32", device="cpu", state_dict=sd)(ids)
    assert torch.equal(got, want)
    jlogits = jax_run["model"].apply({"params": jparams},
                                     jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), atol=1e-4,
                               rtol=0)


def test_serving_a_corrupt_tag_raises(tmp_path):
    engine = _port(seed=3)
    engine.save_checkpoint(str(tmp_path))
    _damage(str(tmp_path / "global_step0" / MODEL_FILE), "bit_flip")
    with pytest.raises(RuntimeError, match="failed verification"):
        deepspeed_tpu_torch.init_inference(
            tlm.GPT(_tcfg()), dtype="fp32", device="cpu",
            checkpoint=str(tmp_path / "global_step0"))
