"""Data parallelism and ZeRO stages 0-2 of the port on 2 gloo ranks,
against the JAX engine on a 2-device fsdp mesh and against the port's own
one-process engine.

A small f32 GPT (2 layers, width 64, seq 32) starts from the JAX init
(``gpt_state_dict_from_jax``); every run takes the same global micro
batches of 4 rows (2 per rank). The 2 ranks are child processes of this
test (``python tests/test_torch_zero.py --worker ...``, torch only: jax is
imported inside the test functions, never at a child's import) that meet
through a ``file://`` rendezvous under the test's temporary directory, with
a 60 s group timeout and a 120 s process timeout, so a hang fails a test
and not the run. One spawn runs every case of the file in turn
(``port_runs``), and each JAX run is shared by its cases.

Tolerances, as in ``test_torch_engine.py`` and
``test_torch_checkpoint.py``: losses to 1e-5 relative; parameters through
their updates (trained minus initial weights) to 1e-3 in relative L2 norm,
the key third of ``c_attn.bias`` apart (its gradient is zero in exact
arithmetic; rounding noise becomes steps of +-lr under Adam). Against the
one-process engine at twice the accumulation steps (each global micro
batch split into two micro batches) the same bounds hold: the exchange sums
in another order than the one-process accumulation. Both ranks must return
the same loss and hold the same parameters bit for bit.
"""

import collections.abc
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from jax_init_cache import cached_init  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=2)
LR = 1e-3
MICRO, WORLD, SEQ, K = 2, 2, 32, 3
CHILD_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
LOSS_RTOL = 1e-5
# losses after gradients rounded to bf16 (8 bits of mantissa) in the
# exchange, against the f32 exchange: a few steps of Adam at lr 1e-3
BF16_RTOL = 1e-3
UPDATE_REL_L2 = 1e-3
CASES = [(stage, gas) for stage in (0, 1, 2) for gas in (1, 2)]


def config(stage, gas=1, micro=MICRO, **over):
    ds = {"train_micro_batch_size_per_gpu": micro,
          "gradient_accumulation_steps": gas, "gradient_clipping": 1.0,
          "optimizer": {"type": "AdamW",
                        "params": {"lr": LR, "weight_decay": 0.1}},
          "zero_optimization": {"stage": stage}, "steps_per_print": 10 ** 9}
    ds.update(over)
    return ds


def global_batches(steps, gas, seed=1, masked=False, world=WORLD):
    """``steps`` lists of ``gas`` global micro batches of ``MICRO * world``
    rows. ``masked``: the first rank's rows keep only their first 8
    tokens, so the ranks' loss weights differ (31 + 31 against 7 + 7)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        step = []
        for _ in range(gas):
            ids = rng.randint(0, SMALL["vocab_size"],
                              size=(MICRO * world, SEQ)).astype(np.int32)
            batch = {"input_ids": ids, "labels": ids}
            if masked:
                mask = np.ones_like(ids)
                mask[:MICRO, 8:] = 0
                batch["attention_mask"] = mask
            step.append(batch)
        out.append(step)
    return out


def split_micro(steps):
    """The same data as micro batches of one rank's size: each global
    micro batch becomes one micro batch per rank, in rank order."""
    return [[{k: v[r:r + MICRO] for k, v in b.items()}
             for b in step for r in range(0, len(b["input_ids"]), MICRO)]
            for step in steps]


def job(name, ds, steps, **kw):
    return dict(name=name, config=ds, steps=steps, **kw)


class RanksRunning(collections.abc.Sequence):
    """Each rank's results (``{job name: result}``) of ranks started by
    ``start_ranks``, waited for at their first use, so that the parent's
    own work (the JAX runs) overlaps the ranks'."""

    def __init__(self, wait):
        self._wait, self._results = wait, None

    def _get(self):
        if self._results is None:
            self._results = self._wait()
        return self._results

    def __getitem__(self, i):
        return self._get()[i]

    def __len__(self):
        return len(self._get())


def run_ranks(jobs, tmp_path, world=WORLD):
    """Run ``jobs`` on ``world`` gloo ranks (child processes); returns
    each rank's results, ``{job name: result}``."""
    return start_ranks(jobs, tmp_path, world)._get()


def start_ranks(jobs, tmp_path, world=WORLD, worker=None,
                timeout=CHILD_TIMEOUT_S):
    """Start ``jobs`` on ``world`` gloo ranks (child processes running
    ``worker``'s ``--worker`` entry, default this file's, each given
    ``timeout`` seconds); returns their ``RanksRunning``."""
    tmp_path = str(tmp_path)
    spec = os.path.join(tmp_path, "jobs.pt")
    torch.save(jobs, spec)
    rdv = os.path.join(tmp_path, "rendezvous")
    procs, outs, logs = [], [], []
    for rank in range(world):
        outs.append(os.path.join(tmp_path, f"rank{rank}.pt"))
        # a file, not a pipe: nobody reads the ranks' output until they end
        logs.append(os.path.join(tmp_path, f"rank{rank}.log"))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(worker or __file__),
                 "--worker", spec, str(rank), str(world), f"file://{rdv}",
                 outs[-1]],
                stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, OMP_NUM_THREADS="1")))

    def wait():
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for rank, (p, log) in enumerate(zip(procs, logs)):
            with open(log) as f:
                assert p.returncode == 0, \
                    f"rank {rank} failed:\n{f.read()[-4000:]}"
        return [torch.load(out, weights_only=False) for out in outs]

    return RanksRunning(wait)


# ---------------------------------------------------------------------------
# the child process: torch and the port only
# ---------------------------------------------------------------------------
BERT_TINY = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=64)


def _model(job):
    """The job's model: the small GPT (``model``: GPTConfig overrides), or
    with ``bert`` a tiny BERT (``model``: BertConfig overrides)."""
    if job.get("bert"):
        from deepspeed_tpu_torch.models import bert as tbert

        return tbert.BertForPreTraining(tbert.BertConfig(
            **{**BERT_TINY, **job.get("model", {})}, dtype=torch.float32))
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    return tlm.GPT(tlm.GPTConfig(**{**SMALL, **job.get("model", {})},
                                 dtype=getattr(torch, job.get("dtype",
                                                              "float32"))))


# how long the liveness probe waits for gloo's worker threads to drop the
# gathered buffers of collectives that have already completed
GLOO_RELEASE_S = 10.0


def _alive_after_release(made, expected):
    """How many of the weakly referenced buffers ``made`` are alive, once
    gloo has let go of them. A gloo collective's work object holds its
    output tensor on the process group's worker thread until that thread
    drops it, which may be just after ``wait()`` has returned on this
    thread (under load, a few milliseconds later): while it holds it, the
    weakref reads alive. So the count is polled until it is at most
    ``expected`` or ``GLOO_RELEASE_S`` has passed; a buffer that the port
    itself still references stays alive past that and is counted."""
    import time

    deadline = time.monotonic() + GLOO_RELEASE_S
    while True:
        alive = sum(r() is not None for r in made)
        if alive <= expected or time.monotonic() > deadline:
            return alive
        time.sleep(0.01)


def _gathered_liveness(engine, batch, remat):
    """Stage 3: a forward and a backward on ``batch`` outside the step,
    counting the full buffers the units' gathers made and how many are
    still alive after the forward and after the backward (``remat``: under
    full remat only the outer unit's buffer outlives the forward)."""
    import weakref

    from deepspeed_tpu_torch.runtime.zero import stage3

    made, real = [], stage3._Unit.gather

    def gather(unit, k):
        full = real(unit, k)
        made.append(weakref.ref(full))
        return full

    stage3._Unit.gather = gather
    try:
        loss = engine._model(**engine._put_batch(batch))
        out = {"forward_made": len(made),
               "forward_alive": _alive_after_release(
                   made, 1 if remat else len(made))}
        loss.backward()
        del loss
        out.update(made=len(made), alive=_alive_after_release(made, 0))
    finally:
        stage3._Unit.gather = real
    engine.optimizer.reduce_grads()  # hand the gradients over, unused
    return out


def _run_job(job, rank):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm.logging import comms_logger

    init = job.get("init_by_rank", {}).get(rank, job.get("init"))
    if init is not None:
        init = {k: v.clone() for k, v in init.items()}
    out = {"error": None}
    from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

    real_mask = ac.bernoulli_mask
    if job.get("record_masks"):
        # the first ``record_masks`` dropout masks this rank draws
        out["masks"] = []

        def recording(*args, **kw):
            mask = real_mask(*args, **kw)
            if len(out["masks"]) < job["record_masks"]:
                out["masks"].append(mask.clone())
            return mask

        ac.bernoulli_mask = recording
    try:
        engine = deepspeed_tpu_torch.initialize(
            model=_model(job), config=job["config"], device="cpu",
            model_parameters=init, seed=job.get("seed", 0))[0]
        if job.get("load"):
            out["tag"] = engine.load_checkpoint(job["load"])[0]
            out["reshard"] = engine.last_reshard.mismatches
        if job.get("liveness"):
            out["liveness"] = _gathered_liveness(
                engine, job["liveness"], job.get("model", {}).get("remat"))
        out["initial"] = {k: v.clone() for k, v in engine.params.items()}
        out.update(losses=[], norms=[], scales=[], skipped=[])
        for i, step in enumerate(job["steps"]):
            if job.get("comms") and i + 1 == len(job["steps"]):
                # the collectives of the last step alone
                comms_logger.reset()
            out["losses"].append(float(engine.train_batch(iter(step))))
            out["norms"].append(engine.get_global_grad_norm())
            out["scales"].append(engine.loss_scale)
            out["skipped"].append(engine.skipped_steps)
            if job.get("save") and i + 1 == job["save"]["after"]:
                engine.save_checkpoint(job["save"]["dir"])
        if job.get("comms"):
            out["comms"] = comms_logger.snapshot()
        if job.get("save16"):
            engine.save_16bit_model(job["save16"])
        if job.get("gathered"):
            from deepspeed_tpu_torch.runtime import zero

            named = dict(engine.module.named_parameters())
            with zero.GatheredParameters(
                    [named[n] for n in job["gathered"]]) as g:
                out["gathered"] = dict(zip(job["gathered"], g.params))
        if job.get("eval"):
            out["eval"] = float(engine.eval_batch(job["eval"]))
        if job.get("dataset"):
            loader = engine.deepspeed_io(job["dataset"], shuffle=False)
            out["io_rows"] = len(next(iter(loader))["input_ids"])
        out["grad_dtypes"] = [str(f.dtype) for f in engine.optimizer.flat_grads]
        out["params"] = {k: v.clone() for k, v in engine.params.items()}
        out["module_numels"] = {k: v.numel() for k, v in
                                engine.module.state_dict().items()}
        out["shard_numels"] = [s.numel()
                               for s in engine.optimizer.shard_params]
        out["count"] = engine.optimizer.count
        out["global_samples"] = engine.global_samples
        if job.get("units"):
            # stage 3: each unit's partitioned leaves, by full name
            out["units"] = {u.name: sorted(u.local)
                            for u in engine.optimizer.units}
    except (NotImplementedError, ValueError) as e:
        if not job.get("raises"):
            raise
        out["error"] = (type(e).__name__, str(e))
    finally:
        ac.bernoulli_mask = real_mask
    return out


def _worker(argv):
    spec, rank, world, url, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    from datetime import timedelta

    from deepspeed_tpu_torch import comm

    torch.set_num_threads(1)
    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          timeout=timedelta(seconds=GROUP_TIMEOUT_S),
                          device_type="cpu")
    results = {}
    for j in torch.load(spec, weights_only=False):
        results[j["name"]] = _run_job(j, rank)
    torch.save(results, out)
    comm.destroy_distributed()
    return 0


# ---------------------------------------------------------------------------
# the parent: the JAX engine and the one-process port engine
# ---------------------------------------------------------------------------
def jax_init(scan_layers=True, **model):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models import transformer_lm as jlm

    jmodel = jlm.GPT(jlm.GPTConfig(**{**SMALL, **model}, dtype=jnp.float32,
                                   scan_layers=scan_layers))
    params = cached_init(jmodel, 0, jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
    return jmodel, params


def jax_run(ds, steps, scan_layers=True, dp=1, fsdp=WORLD, model=None):
    """Losses and final parameters (port names) of the JAX engine on a
    (dp, fsdp) mesh of the virtual CPU devices (default: 2-device fsdp);
    and the initial parameters. ``model``: GPTConfig overrides."""
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.parallel.mesh import MeshTopology
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    jmodel, params = jax_init(scan_layers, **(model or {}))
    tcfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    start = gpt_state_dict_from_jax(jax.device_get(params), tcfg)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=dp, fsdp=fsdp,
                              devices=jax.devices()[:dp * fsdp]))
    losses = [float(jeng.train_batch(iter(step))) for step in steps]
    return {"losses": np.array(losses), "start": start,
            "params": gpt_state_dict_from_jax(jax.device_get(jeng.params),
                                              tcfg),
            "skipped": jeng.skipped_steps}


def one_process(ds, steps, init, model=None):
    """The port's engine without a process group, on the same data as
    micro batches of one rank's size. ``model``: GPTConfig overrides."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    engine = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**{**SMALL, **(model or {})},
                                    dtype=torch.float32)),
        config=ds, device="cpu",
        model_parameters={k: v.clone() for k, v in init.items()})[0]
    losses = [float(engine.train_batch(iter(s))) for s in split_micro(steps)]
    return {"losses": np.array(losses), "engine": engine,
            "params": {k: v.clone()
                       for k, v in engine.module.state_dict().items()}}


def assert_updates_close(got, want, start, k=K):
    """``got`` against ``want`` (state dicts), ``k`` steps after
    ``start``: the updates to ``UPDATE_REL_L2`` in relative L2 norm, the
    key third of ``c_attn.bias`` to ``k * 2 * LR``."""
    C = SMALL["n_embd"]
    diff_sq = upd_sq = 0.0
    for name, w in want.items():
        g, s = got[name].float(), start[name].float()
        w = w.float()
        if name.endswith("attn.c_attn.bias"):
            torch.testing.assert_close(g[C:2 * C], w[C:2 * C], rtol=0,
                                       atol=k * 2 * LR, msg=name)
            g, w, s = (torch.cat([x[:C], x[2 * C:]]) for x in (g, w, s))
        diff_sq += float(((g - w) ** 2).sum())
        upd_sq += float(((w - s) ** 2).sum())
    assert (diff_sq / upd_sq) ** 0.5 <= UPDATE_REL_L2


def assert_ranks_agree(per_rank, name):
    a, b = (r[name] for r in per_rank)
    assert a["losses"] == b["losses"], name
    assert a["params"].keys() == b["params"].keys()
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), (name, k)


MATRIX_STEPS = {gas: global_batches(K, gas) for gas in (1, 2)}
MASKED_STEPS = global_batches(K, 1, seed=3, masked=True)
FP16 = {"fp16": {"enabled": True, "initial_scale_power": 20,
                 "hysteresis": 1}}
LAMB = {"optimizer": {"type": "Lamb",
                      "params": {"lr": LR, "weight_decay": 0.1}}}


@pytest.fixture(scope="module")
def start():
    import jax

    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    tcfg = tlm.GPTConfig(**SMALL, dtype=torch.float32)
    return {scan: gpt_state_dict_from_jax(
        jax.device_get(jax_init(scan)[1]), tcfg) for scan in (True, False)}


@pytest.fixture(scope="module")
def port_runs(start, tmp_path_factory):
    """Every 2-rank case of this file, in one spawn of 2 processes."""
    init = start[True]
    other = {k: v + 0.5 for k, v in init.items()}
    jobs = [job(f"s{stage}g{gas}", config(stage, gas), MATRIX_STEPS[gas],
                init=init) for stage, gas in CASES]
    jobs += [
        job("masked", config(1), MASKED_STEPS, init=init,
            eval=MASKED_STEPS[0][0]),
        job("lamb", config(1, **LAMB), MATRIX_STEPS[1], init=start[False]),
        job("fp16", config(1, **FP16), MATRIX_STEPS[1], init=init,
            dtype="float16"),
        job("rank0_wins", config(1), [], init_by_rank={0: init, 1: other},
            dataset=[{"input_ids": np.zeros(SEQ, np.int32)}] * 8),
        job("bf16_exchange", config(1, communication_data_type="bf16"),
            MATRIX_STEPS[1], init=init),
        # stage 3 runs a GPT and a BERT (test_torch_zero3.py,
        # test_torch_bert_dp.py); a mixture of experts is still refused
        job("stage3", config(3), [], raises=True,
            model={"moe_num_experts": 2, "moe_top_k": 1}),
        # tp is ported for a GPT; a BERT under tp waits for A.9 part 2
        job("tp2", config(1, tpu={"mesh": {"tp": 2}}), [], raises=True,
            bert=True),
        job("bad_rows", config(1), [[{k: v[:MICRO] for k, v in
                                      MATRIX_STEPS[1][0][0].items()}]],
            init=init, raises=True),
    ]
    return start_ranks(jobs, tmp_path_factory.mktemp("zero"))


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(key):
        if key not in cache:
            stage, gas, kind = key
            over = {"lamb": LAMB}.get(kind, {})
            steps = MASKED_STEPS if kind == "masked" else MATRIX_STEPS[gas]
            cache[key] = jax_run(config(stage, gas, **over), steps,
                                 scan_layers=kind != "lamb")
        return cache[key]
    return get


@pytest.mark.parametrize("stage,gas", CASES)
def test_zero_matches_jax(stage, gas, port_runs, jax_runs):
    name = f"s{stage}g{gas}"
    # the JAX run first: the ranks may still be running
    want = jax_runs((stage, gas, "plain"))
    assert_ranks_agree(port_runs, name)
    got = port_runs[0][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert_updates_close(got["params"], want["params"], want["start"])
    assert got["count"] == K
    assert got["global_samples"] == K * gas * MICRO * WORLD


@pytest.mark.parametrize("stage,gas", CASES)
def test_zero_matches_one_process(stage, gas, port_runs, start):
    name = f"s{stage}g{gas}"
    got = port_runs[1][name]
    ref = one_process(config(stage, 2 * gas), MATRIX_STEPS[gas], start[True])
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=LOSS_RTOL)
    assert_updates_close(got["params"], ref["params"], start[True])
    np.testing.assert_allclose(got["norms"][-1],
                               ref["engine"].get_global_grad_norm(),
                               rtol=LOSS_RTOL)


def test_masked_batch_with_unequal_counts_matches_jax(port_runs, jax_runs):
    """The first rank's rows carry 14 loss weights, the second's 62;
    each rank weights its mean by its share of the 76, so the loss and the
    gradient are the global batch's."""
    assert_ranks_agree(port_runs, "masked")
    got, want = port_runs[0]["masked"], jax_runs((1, 1, "masked"))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert_updates_close(got["params"], want["params"], want["start"])
    # eval_batch's global mean against a one-process engine's mean over
    # the same 4 rows, from the trained parameters
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    ref = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float32)),
        config=config(1, micro=MICRO * WORLD), device="cpu",
        model_parameters={k: v.clone() for k, v in got["params"].items()})[0]
    np.testing.assert_allclose(
        got["eval"], float(ref.eval_batch(MASKED_STEPS[0][0])),
        rtol=LOSS_RTOL)


def test_lamb_at_stage_1_matches_jax(port_runs, jax_runs):
    """LAMB: a parameter that straddles the two shards takes one trust ratio
    from the per-parameter sums of both."""
    assert_ranks_agree(port_runs, "lamb")
    got, want = port_runs[0]["lamb"], jax_runs((1, 1, "lamb"))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert_updates_close(got["params"], want["params"], want["start"])


def test_fp16_skips_agree_across_ranks(port_runs, start):
    """fp16 from a loss scale of 2^20: the first step overflows and is
    skipped on both ranks (the flag is all-reduced), the scale halves on
    both, as in the one-process engine."""
    a, b = port_runs[0]["fp16"], port_runs[1]["fp16"]
    assert a["skipped"] == b["skipped"] and a["scales"] == b["scales"]
    assert a["losses"] == b["losses"]
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    ref = deepspeed_tpu_torch.initialize(
        model=tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float16)),
        config=config(1, 2, **FP16), device="cpu",
        model_parameters={k: v.clone() for k, v in start[True].items()})[0]
    skipped, scales = [], []
    for step in split_micro(MATRIX_STEPS[1]):
        ref.train_batch(iter(step))
        skipped.append(ref.skipped_steps)
        scales.append(ref.loss_scale)
    assert a["skipped"] == skipped and a["scales"] == scales
    assert a["skipped"][-1] >= 1
    assert a["count"] == K - a["skipped"][-1]


def test_rank_0_parameters_win(port_runs, start):
    """Rank 1 was given other weights; both start from rank 0's."""
    for r in port_runs:
        for k, v in r["rank0_wins"]["initial"].items():
            assert torch.equal(v, start[True][k]), k


HSDP_STEPS = global_batches(K, 1, seed=9, world=4)


@pytest.fixture(scope="module")
def hsdp_runs(start, tmp_path_factory):
    """4 gloo ranks on a (dp 2, fsdp 2) mesh at stage 1: the optimizer
    state sharded over fsdp, the shard's gradient all-reduced over dp
    (groups from the DeviceMesh)."""
    ds = config(1, tpu={"mesh": {"dp": 2, "fsdp": 2}})
    return start_ranks([job("hsdp", ds, HSDP_STEPS, init=start[True])],
                       tmp_path_factory.mktemp("hsdp"), world=4)


def test_dp_by_fsdp_mesh_matches_jax_and_one_process(hsdp_runs, start):
    # the JAX run first: the ranks may still be running
    want = jax_run(config(1), HSDP_STEPS, dp=2, fsdp=2)
    a = hsdp_runs[0]["hsdp"]
    for r in hsdp_runs[1:]:
        assert r["hsdp"]["losses"] == a["losses"]
        for k, v in a["params"].items():
            assert torch.equal(r["hsdp"]["params"][k], v), k
    np.testing.assert_allclose(a["losses"], want["losses"], rtol=LOSS_RTOL)
    assert_updates_close(a["params"], want["params"], want["start"])
    ref = one_process(config(1, 4), HSDP_STEPS, start[True])
    np.testing.assert_allclose(a["losses"], ref["losses"], rtol=LOSS_RTOL)
    assert_updates_close(a["params"], ref["params"], start[True])


def test_deepspeed_io_loads_the_global_micro_batch(port_runs):
    for r in port_runs:
        assert r["rank0_wins"]["io_rows"] == MICRO * WORLD


def test_bf16_exchange(port_runs):
    """``communication_data_type: bf16`` on an f32 model: the gradient
    buffer and its reduce-scatter are bf16 (the update casts back to f32),
    so the losses stay within bf16's rounding of the f32 exchange's."""
    assert_ranks_agree(port_runs, "bf16_exchange")
    got, ref = port_runs[0]["bf16_exchange"], port_runs[0]["s1g1"]
    assert got["grad_dtypes"] == ["torch.bfloat16"]
    assert ref["grad_dtypes"] == ["torch.float32"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=BF16_RTOL)
    assert got["losses"][1:] != ref["losses"][1:]


@pytest.mark.parametrize("name,kind,words", [
    ("stage3", "NotImplementedError", "ROADMAP A.3"),
    ("tp2", "NotImplementedError", "ROADMAP A.9"),
    ("bad_rows", "ValueError", "must be the global micro batch"),
])
def test_refusals(name, kind, words, port_runs):
    for r in port_runs:
        assert r[name]["error"] is not None, name
        assert r[name]["error"][0] == kind
        assert words in r[name]["error"][1]


@pytest.mark.parametrize("world", [1, 2, 3])
def test_lamb_over_flat_shards_matches_per_leaf(world):
    """LAMB over each rank's flat shard (its leaf runs' norms, the partial
    sums added over the ranks) against LAMB over the whole leaves, for two
    steps. The ranks run in one process: each rank's ``reduce`` waits for
    the others' partial sums in turn, so they are summed before any rank
    takes its ratios."""
    import threading

    from deepspeed_tpu_torch.runtime.optimizer import Lamb
    from deepspeed_tpu_torch.runtime.zero.sharding import FlatPartition

    gen = torch.Generator().manual_seed(3)
    shapes = [(10, 7), (3,), (250,), (97, 3)]
    leaves = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) for s in shapes]
             for _ in range(2)]
    names = [f"w{i}" for i in range(len(shapes))]
    whole = Lamb([x.clone() for x in leaves], lr=1e-2, weight_decay=0.1)
    for g in grads:
        whole.step(g)

    barrier = threading.Barrier(world)
    partial = [None] * world

    def reduce(rank):
        def sum_over_ranks(x):
            partial[rank] = x.clone()
            barrier.wait()
            x.copy_(sum(partial))
            barrier.wait()
            return x
        return sum_over_ranks

    flats, opts = [], []
    for rank in range(world):
        named = list(zip(names, [x.clone() for x in leaves]))
        part = FlatPartition(named, world, rank)
        (group,) = part.groups
        flat = part.flatten(named)[0]
        flats.append((part, flat))
        opts.append(Lamb([flat[group.start:group.end]], lr=1e-2,
                         weight_decay=0.1,
                         runs=[(group.shard_runs(), len(group.names))],
                         reduce=reduce(rank)))

    def run(rank):
        part, flat = flats[rank]
        (group,) = part.groups
        for g in grads:
            gflat = torch.zeros(group.padded)
            for view, x in zip(part.views([gflat]).values(), g):
                view.copy_(x)
            opts[rank].step([gflat[group.start:group.end]])

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    (group,) = flats[0][0].groups
    if world > 1:  # some leaf straddles two ranks' shards
        assert len([x for r in range(world) for x in group.shard_overlaps(r)]
                   ) > len(shapes)
    # each rank's shard of the flat buffer, put together
    got = torch.cat([flat[g.start:g.end] for part, flat in flats
                     for g in part.groups])
    for leaf, off, n in zip(whole.params, group.offsets, group.numels):
        torch.testing.assert_close(got[off:off + n].view_as(leaf), leaf,
                                   rtol=1e-6, atol=1e-7)
    assert not got[group.numel:].any()


@pytest.mark.parametrize("mesh", [{"dp": 2}, {"fsdp": 2}, {"dp": 1, "fsdp": 4}])
def test_mesh_without_a_group_refused(mesh):
    """A mesh of more than one rank with no process group raises, naming
    ``init_distributed``, instead of training on one rank."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models import transformer_lm as tlm

    assert not comm.is_initialized()
    with pytest.raises(ValueError, match="comm.init_distributed"):
        deepspeed_tpu_torch.initialize(
            model=tlm.GPT(tlm.GPTConfig(**SMALL, dtype=torch.float32)),
            config=config(1, tpu={"mesh": mesh}), device="cpu")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(sys.argv[2:]))
