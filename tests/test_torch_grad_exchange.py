"""The explicit gradient exchanges of the port on 2 gloo ranks (4 for the
hierarchical exchange), against the JAX engine on a 2-device dp mesh: the
deferred bucketed exchange at an f32 and a bf16 wire, the int8 exchange
bucketed and per leaf, their checkpoints, the fp16 overflow skip and the
refusals. The 1-bit optimizers are ``test_torch_onebit.py``'s.

The harness and data are ``test_torch_zero.py``'s: a small f32 GPT (2
layers, width 64, seq 32) from the JAX init, global micro batches of 4
rows, the ranks as child processes with their own timeouts.

Tolerances: losses to 1e-5 relative and parameters through their updates to
1e-3 in relative L2 (``test_torch_zero.py``'s bounds). The f32 deferred
exchange changes only the order of the f32 sums, so it is held to the
same bounds against the JAX baseline engine (no deferred exchange) and
against the port's own stage-0 exchange. The bf16 wire rounds each
bucket's sum at each hop of a ring on NCCL, so it is held to the JAX run's
loss (1e-3 relative) and to convergence only. The int8 exchange quantizes
the same elements as the JAX one (the JAX flat layout): its losses and
updates take the same bounds, and its error feedback agrees with the JAX
engine's to within one quantisation step of the block (the scale): the
sums before quantisation differ from JAX's by f32 rounding (autograd's
gradients are not XLA's to the last bit), which can move a value across a
rounding boundary of the int8 grid.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_zero as tz  # noqa: E402

CHILD_TIMEOUT_S = 150
BF16_RTOL = 1e-3
BUCKET_MB = 0.02  # ~5000 f32 elements: the small GPT in several buckets
STEPS = tz.global_batches(4, 2, seed=21)
MASKED = tz.global_batches(3, 1, seed=22, masked=True)
STEPS_FP16 = tz.global_batches(3, 1, seed=23)


def gx_config(gas=2, stage=0, **over):
    return tz.config(stage, gas, **over)


DEFERRED32 = {"tpu": {"grad_exchange": {"deferred": True,
                                        "bucket_mb": BUCKET_MB,
                                        "wire_dtype": "fp32"}}}
DEFERRED16 = {"tpu": {"grad_exchange": {"deferred": True,
                                        "bucket_mb": BUCKET_MB}}}
INT8_BUCKETED = {"communication_data_type": "int8",
                 "tpu": {"grad_exchange": {"bucket_mb": BUCKET_MB}}}
INT8_LEAF = {"communication_data_type": "int8"}


def run_ranks(jobs, tmp_path, world=tz.WORLD):
    """``tz.run_ranks`` with this file's worker."""
    tmp_path = str(tmp_path)
    spec = os.path.join(tmp_path, "jobs.pt")
    torch.save(jobs, spec)
    rdv = os.path.join(tmp_path, "rendezvous")
    procs, outs = [], []
    for rank in range(world):
        outs.append(os.path.join(tmp_path, f"rank{rank}.pt"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", spec,
             str(rank), str(world), f"file://{rdv}", outs[-1]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=dict(os.environ, OMP_NUM_THREADS="1")))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-4000:]}"
    return [torch.load(out, weights_only=False) for out in outs]


# ---------------------------------------------------------------------------
# the child process: torch and the port only
# ---------------------------------------------------------------------------
def _exchange_state(engine):
    cx = engine._cx
    return {k: [b.clone() for b in getattr(cx, k)]
            for k in ("worker_error", "server_error")}


def _run_job(job, rank):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.comm.logging import comms_logger

    out = {"error": None}
    try:
        init = job.get("init")
        engine = deepspeed_tpu_torch.initialize(
            model=tz._model(job), config=job["config"], device="cpu",
            model_parameters=(None if init is None else
                              {k: v.clone() for k, v in init.items()}),
            seed=job.get("seed", 0))[0]
        if job.get("load"):
            out["tag"] = engine.load_checkpoint(job["load"])[0]
        out["start_params"] = {k: v.clone() for k, v in engine.params.items()}
        out.update(losses=[], norms=[], skipped=[], exchange=[], forced=[])
        for i, step in enumerate(job["steps"]):
            if job.get("forced"):
                # start the step from the JAX engine's state
                state = job["forced"][i]
                engine._restore_module(state["params"])
                engine._cx.load_state(state["opt"][rank])
            if job.get("comms") and i + 1 == len(job["steps"]):
                comms_logger.reset()
            out["losses"].append(float(engine.train_batch(iter(step))))
            out["norms"].append(engine.get_global_grad_norm())
            out["skipped"].append(engine.skipped_steps)
            if engine._cx is not None and job.get("record"):
                out["exchange"].append(_exchange_state(engine))
            if job.get("forced"):
                out["forced"].append({
                    "params": {k: v.clone()
                               for k, v in engine.params.items()},
                    "moments": engine.optimizer.state_dict()["state"],
                    "exchange": _exchange_state(engine)})
            if job.get("save") and i + 1 == job["save"]["after"]:
                engine.save_checkpoint(job["save"]["dir"])
        if job.get("comms"):
            out["comms"] = comms_logger.snapshot()
            out["level_bytes"] = dict(comms_logger.level_bytes)
        out["params"] = {k: v.clone() for k, v in engine.params.items()}
        out["count"] = engine.optimizer.count
        out["mode"] = engine._cx_mode
        if engine._cx is not None:
            out["final_exchange"] = _exchange_state(engine)
            if engine._cx_mode == "onebit":
                out["moments"] = engine.optimizer.state_dict()["state"]
            plan = engine._cx.plan
            out["buckets"] = plan.num_buckets if plan else 0
            out["bucket_sizes"] = plan.bucket_sizes() if plan else ()
    except (NotImplementedError, ValueError) as e:
        if not job.get("raises"):
            raise
        out["error"] = (type(e).__name__, str(e))
    return out


def _worker(argv):
    spec, rank, world, url, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, tz.ROOT)
    from datetime import timedelta

    from deepspeed_tpu_torch import comm

    torch.set_num_threads(1)
    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          timeout=timedelta(seconds=tz.GROUP_TIMEOUT_S),
                          device_type="cpu")
    results = {}
    for j in torch.load(spec, weights_only=False):
        results[j["name"]] = _run_job(j, rank)
    torch.save(results, out)
    comm.destroy_distributed()
    return 0


# ---------------------------------------------------------------------------
# the parent: the JAX engine
# ---------------------------------------------------------------------------
def jax_run(ds, steps, scan_layers=True, dp=tz.WORLD):
    """The JAX engine on a dp mesh of the virtual CPU devices: losses,
    final parameters (port names), the start, the optimizer state
    (numpy) and the skipped steps."""
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.parallel.mesh import MeshTopology
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    jmodel, params = tz.jax_init(scan_layers)
    tcfg = tlm.GPTConfig(**tz.SMALL, dtype=torch.float32,
                         scan_layers=scan_layers)
    start = gpt_state_dict_from_jax(jax.device_get(params), tcfg)
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=ds, model_parameters=params,
        topology=MeshTopology(dp=dp, devices=jax.devices()[:dp]))
    losses = [float(jeng.train_batch(iter(step))) for step in steps]
    return {"losses": np.array(losses), "start": start, "cfg": tcfg,
            "params": gpt_state_dict_from_jax(jax.device_get(jeng.params),
                                              tcfg),
            "opt_state": jax.device_get(jeng._opt_state),
            "skipped": jeng.skipped_steps}


def init_state(scan_layers=True):
    import jax

    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.module_inject.jax_params import \
        gpt_state_dict_from_jax

    return gpt_state_dict_from_jax(
        jax.device_get(tz.jax_init(scan_layers)[1]),
        tlm.GPTConfig(**tz.SMALL, dtype=torch.float32))


RUNS = {
    # name: (config, steps, JAX scan_layers)
    "deferred32": (gx_config(**DEFERRED32), STEPS, True),
    "deferred16": (gx_config(**DEFERRED16), STEPS, True),
    "int8_bucketed": (gx_config(**INT8_BUCKETED), STEPS, True),
    "int8_leaf": (gx_config(**INT8_LEAF), STEPS, True),
    "int8_leaf_unscanned": (gx_config(**INT8_LEAF), STEPS, False),
    "deferred32_masked": (gx_config(gas=1, **DEFERRED32), MASKED, True),
    "stage0": (gx_config(), STEPS, True),
}
REFUSALS = {
    # name: (config, words of the JAX engine)
    "int8_stage1": (gx_config(stage=1, **INT8_LEAF),
                    "int8 compressed gradient exchange requires ZeRO stage "
                    "<= 0 (got 1)"),
    "deferred_stage2": (gx_config(stage=2, **DEFERRED32),
                        "deferred compressed gradient exchange requires ZeRO "
                        "stage <= 0 (got 2)"),
    "int8_fsdp": (gx_config(tpu={"mesh": {"dp": 1, "fsdp": 2}},
                            communication_data_type="int8"),
                  "compressed gradient exchange runs over the dp axis "
                  "only; mesh axis 'fsdp' has size 2"),
    "int8_offload": (gx_config(communication_data_type="int8",
                               zero_optimization={
                                   "stage": 0, "offload_optimizer":
                                   {"device": "cpu"}}),
                     "int8 compressed gradient exchange cannot combine with "
                     "offload_optimizer"),
    "int8_hierarchical": (gx_config(communication_data_type="int8", tpu={
        "grad_exchange": {"hierarchical": "auto"}}),
        "tpu.grad_exchange.hierarchical requires the deferred"),
    "hierarchical_on_alone": (gx_config(tpu={"grad_exchange": {
        "hierarchical": "on"}}),
        "tpu.grad_exchange.hierarchical: on requires the deferred exchange"),
    "hierarchical_on_flat": (gx_config(tpu={"grad_exchange": {
        "deferred": True, "hierarchical": "on"}}),
        "the dp axis has no slice structure"),
    "offload_stays_a10": (gx_config(zero_optimization={
        "stage": 0, "offload_param": {"device": "cpu"}}), "ROADMAP A.10"),
    "tp_stays_a9": (gx_config(tpu={"mesh": {"dp": 1, "sp": 2}}),
                    "ROADMAP A.9"),
}
FP16_INT8 = gx_config(gas=1, communication_data_type="int8",
                      fp16={"enabled": True, "initial_scale_power": 30,
                            "hysteresis": 1})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every 2-rank case of this file, in one spawn."""
    inits = {True: init_state(True), False: init_state(False)}
    ckpt = str(tmp_path_factory.mktemp("gx_ckpt"))
    jobs = [tz.job(name, ds, steps, init=inits[scan], record=True,
                   model={"scan_layers": scan})
            for name, (ds, steps, scan) in RUNS.items()]
    jobs += [tz.job(name, ds, [], raises=True)
             for name, (ds, _) in REFUSALS.items()]
    jobs.append(tz.job("fp16_int8", FP16_INT8, STEPS_FP16, init=inits[True],
                       dtype="float16", record=True))
    for name, ds in (("deferred32", RUNS["deferred32"][0]),
                     ("int8_bucketed", RUNS["int8_bucketed"][0]),
                     ("int8_leaf", RUNS["int8_leaf"][0])):
        d = os.path.join(ckpt, name)
        jobs.append(tz.job(f"save_{name}", ds, STEPS, init=inits[True],
                           save={"dir": d, "after": 2}, record=True))
        jobs.append(tz.job(f"resume_{name}", ds, STEPS[2:], init=None,
                           seed=7, load=d, record=True))
    jobs.append(tz.job("comms_deferred16", gx_config(
        comms_logger={"enabled": True}, **DEFERRED16), STEPS[:1],
        init=inits[True], comms=True))
    jobs.append(tz.job("comms_stage0", gx_config(
        comms_logger={"enabled": True}), STEPS[:1], init=inits[True],
        comms=True))
    jobs.append(tz.job("comms_int8", gx_config(
        comms_logger={"enabled": True}, **INT8_BUCKETED), STEPS[:1],
        init=inits[True], comms=True))
    return {"ranks": run_ranks(jobs, tmp_path_factory.mktemp("gx")),
            "inits": inits}


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(name):
        if name not in cache:
            ds, steps, scan = RUNS[name]
            cache[name] = jax_run(ds, steps, scan_layers=scan)
        return cache[name]
    return get


def assert_ranks_agree(per_rank, name):
    a = per_rank[0][name]
    for r in per_rank[1:]:
        assert r[name]["losses"] == a["losses"], name
        for k, v in a["params"].items():
            assert torch.equal(r[name]["params"][k], v), (name, k)


@pytest.mark.parametrize("name", ["deferred32", "int8_bucketed", "int8_leaf",
                                  "int8_leaf_unscanned",
                                  "deferred32_masked"])
def test_exchange_matches_jax(name, runs, jax_runs):
    """Losses and updates of each exchange against the JAX engine in the
    same mode (scanned and unscanned layouts; unequal label counts across
    the ranks in the masked case, where each worker's loss is its own
    mean)."""
    assert_ranks_agree(runs["ranks"], name)
    got, want = runs["ranks"][0][name], jax_runs(name)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=tz.LOSS_RTOL)
    tz.assert_updates_close(got["params"], want["params"], want["start"],
                            k=len(got["losses"]))


def test_deferred_fp32_matches_the_baselines(runs, jax_runs):
    """The f32 deferred exchange against the JAX baseline engine (no
    deferred exchange: an all-reduce per micro step) and the port's stage-0
    exchange: the same step but for the order of the f32 sums."""
    got = runs["ranks"][0]["deferred32"]
    assert got["mode"] == "deferred" and got["buckets"] > 1
    for want in (jax_runs("stage0"), runs["ranks"][0]["stage0"]):
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=tz.LOSS_RTOL)
        tz.assert_updates_close(got["params"], want["params"],
                                jax_runs("stage0")["start"], k=4)


def test_deferred_bf16_converges_near_jax(runs, jax_runs):
    """The bf16 wire: the JAX run's losses to 1e-3, and the loss falls."""
    assert_ranks_agree(runs["ranks"], "deferred16")
    got = runs["ranks"][0]["deferred16"]["losses"]
    np.testing.assert_allclose(got, jax_runs("deferred16")["losses"],
                               rtol=BF16_RTOL)
    f32 = runs["ranks"][0]["deferred32"]["losses"]
    np.testing.assert_allclose(got, f32, rtol=BF16_RTOL)
    assert got[-1] < got[0]


def assert_within_one_step(a, b, what, block=512, slack=1.1):
    """Residuals ``a`` and ``b`` of int8 blocks of ``block`` elements
    differ by at most one quantisation step per block: the residual of a
    block lies within half a step of 0, so a step is at least twice the
    largest residual of the block on either side (``slack`` for the two
    sides' scales, which differ by rounding)."""
    pad = (-a.numel()) % block
    ab = torch.nn.functional.pad(torch.stack([a, b]).reshape(2, -1), (0, pad))
    ab = ab.view(2, -1, block)
    step = 2 * ab.abs().amax(dim=(0, 2))
    diff = (ab[0] - ab[1]).abs().amax(dim=1)
    assert bool((diff <= slack * step + 1e-30).all()), (
        what, float((diff / step.clamp(min=1e-30)).max()))


@pytest.mark.parametrize("name", ["int8_bucketed", "int8_leaf",
                                  "int8_leaf_unscanned"])
def test_int8_error_feedback_matches_jax(name, runs, jax_runs):
    """Each rank's worker and server residuals after the run against the
    JAX engine's (``compressed_state_from_jax``: the same buffers, in the
    same layout), to one quantisation step of the largest block scale."""
    from deepspeed_tpu_torch.module_inject.jax_params import \
        compressed_state_from_jax

    want = jax_runs(name)
    for rank, r in enumerate(runs["ranks"]):
        got = r[name]["final_exchange"]
        ref = compressed_state_from_jax(want["opt_state"], want["cfg"],
                                        "int8", rank, tz.WORLD)
        for field in ("worker_error", "server_error"):
            theirs = ref["grad_exchange"][field]
            assert [t.numel() for t in theirs] == [
                t.numel() for t in got[field]], field
            for a, b in zip(got[field], theirs):
                assert_within_one_step(a, b, (name, field, rank))
            diff = sum(float(((a - b) ** 2).sum())
                       for a, b in zip(got[field], theirs))
            norm = sum(float((b ** 2).sum()) for b in theirs)
            assert diff <= 0.05 * norm, (field, rank, diff, norm)


def test_fp16_overflow_skips_keep_error_feedback(runs):
    """fp16 from a loss scale of 2^30: the steps overflow and are skipped
    on both ranks until the scale falls; a skipped step leaves the
    parameters' count and the error feedback as they were."""
    a, b = (r["fp16_int8"] for r in runs["ranks"])
    assert a["skipped"] == b["skipped"] and a["losses"] == b["losses"]
    assert a["skipped"][0] == 1
    for i, skipped in enumerate(a["skipped"]):
        was = a["exchange"][i - 1] if i else None
        now = a["exchange"][i]
        if skipped > (a["skipped"][i - 1] if i else 0):
            for field in now:
                for x, y in zip(now[field], was[field] if was else
                                [torch.zeros_like(t) for t in now[field]]):
                    assert torch.equal(x, y), (i, field)
    assert a["count"] == len(a["losses"]) - a["skipped"][-1]


@pytest.mark.parametrize("name", ["deferred32", "int8_bucketed",
                                  "int8_leaf"])
def test_checkpoint_resumes_identically(name, runs):
    """A tag saved after 2 steps, loaded into a new engine of another
    seed: the 2 resumed steps equal the uninterrupted run's, losses,
    parameters and error feedback bit for bit."""
    for r in runs["ranks"]:
        full, resumed = r[f"save_{name}"], r[f"resume_{name}"]
        assert resumed["tag"] == "global_step2"
        assert resumed["losses"] == full["losses"][2:]
        for k, v in full["params"].items():
            assert torch.equal(resumed["params"][k], v), k
        for field, bufs in full["final_exchange"].items():
            for x, y in zip(resumed["final_exchange"][field], bufs):
                assert torch.equal(x, y), field


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals(name, runs):
    """Each mode the JAX engine refuses is refused with its words; the
    other ports' refusals stay (a BERT's JAX layout is ported:
    test_torch_bert_dp.py)."""
    words = REFUSALS[name][1]
    for r in runs["ranks"]:
        kind, msg = r[name]["error"]
        assert words in msg, msg


def test_wire_bytes_per_step(runs):
    """One step at gas 2: the stage-0 engine all-reduces the f32 gradient
    twice (each micro step), the deferred exchange once, per bucket, at
    half the bytes (bf16), int8 once at a byte per element (padded to whole
    blocks) plus an f32 scale per 512."""
    r = runs["ranks"][0]
    n = sum(v.numel() for v in runs["inits"][True].values())
    stage0 = r["comms_stage0"]["comms"]
    deferred = r["comms_deferred16"]["comms"]
    int8 = r["comms_int8"]["comms"]
    ring = 2 * (tz.WORLD - 1) / tz.WORLD
    buckets = [k for k in deferred if k.startswith("bucketed_grad_exchange")]
    assert len(buckets) == r["deferred32"]["buckets"]
    assert sum(deferred[k]["bytes"] for k in buckets) == 2 * n
    assert sum(deferred[k]["wire_bytes"] for k in buckets) == pytest.approx(
        ring * 2 * n, rel=1e-3)
    # the f32 gradient buffer (padded to 64 elements), once per micro step;
    # the 4-byte records are the loss and its weights
    grads = {size: count for size, count in
             stage0["all_reduce"]["msg_sizes"].items() if size > 4}
    assert grads == {4 * (n + (-n) % 64): 2}
    payload = sum(v["wire_bytes"] for k, v in int8.items()
                  if k.startswith("quantized_all_reduce.bucket")
                  and not k.endswith(".scales"))
    scales = sum(v["wire_bytes"] for k, v in int8.items()
                 if k.endswith(".scales"))
    # each bucket padded to a multiple of w blocks of 512, one byte each
    padded = [b + (-b) % (tz.WORLD * 512)
              for b in r["int8_bucketed"]["bucket_sizes"]]
    assert payload == pytest.approx(ring * sum(padded), abs=len(padded))
    assert scales == pytest.approx(ring * 4 * sum(padded) / 512,
                                   abs=len(padded))


def test_hierarchical_on_four_ranks(tmp_path):
    """4 gloo ranks in 2 slices (``dcn_slices``): a bf16 reduce-scatter and
    all-gather within each slice (logged "ici"), the int8 exchange of the
    shard across slices ("dcn"); against the flat f32 exchange of the same
    run (bf16 and int8 rounding: 1e-3 in the loss) and the JAX engine's
    hierarchical run."""
    steps = tz.global_batches(3, 1, seed=24, world=4)
    hier = gx_config(gas=1, comms_logger={"enabled": True}, tpu={
        "grad_exchange": {"deferred": True, "hierarchical": "on",
                          "dcn_slices": 2, "bucket_mb": BUCKET_MB}})
    flat = gx_config(gas=1, **DEFERRED32)
    init = init_state(True)
    per_rank = run_ranks([tz.job("hier", hier, steps, init=init, comms=True),
                          tz.job("flat", flat, steps, init=init)],
                         tmp_path, world=4)
    a = per_rank[0]["hier"]
    assert all(r["hier"]["losses"] == a["losses"] for r in per_rank)
    np.testing.assert_allclose(a["losses"], per_rank[0]["flat"]["losses"],
                               rtol=BF16_RTOL)
    assert a["level_bytes"]["ici"] > 0 and a["level_bytes"]["dcn"] > 0
    assert any(k.endswith(".dcn") for k in a["comms"])
    want = jax_run(hier, steps, dp=4)
    np.testing.assert_allclose(a["losses"], want["losses"], rtol=BF16_RTOL)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.exit(_worker(sys.argv[2:]))
