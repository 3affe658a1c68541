"""The port's front-door policy objects against the JAX package's.

Seeded random scripts, each with a fake clock, run through both packages'
classes, and every decision, reason string and bus event (apart from its
``ts``) must be the same: the silence schedule and ``FleetHealth``,
``RequestJournal``, ``FleetCoordinator`` with roles and pools,
``PrefixRouter`` and ``route_trace`` under live masks and outages,
``SLOAdmissionController`` (aging, starvation, hysteresis) and
``GracefulDrain`` over a fake scheduler, driven by a real SIGTERM to this
process. Then two replica processes of a tiny ring GPT on the CPU, through
``chip_smoke.py``'s ``ReplicaFleet`` (one thread each), serve a trace while one
of them is killed after 4 delivered tokens: every request completes, equal
to the JAX package's in-process scheduler token for token.
"""

import dataclasses
import os
import signal
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.serving as jserving
import deepspeed_tpu.serving.admission as jadmission
import deepspeed_tpu.serving.fleet as jfleet
import deepspeed_tpu.serving.router as jrouter
import deepspeed_tpu.telemetry.bus as jbus
import deepspeed_tpu.utils.health_state as jhealth
import deepspeed_tpu_torch.serving.admission as tadmission
import deepspeed_tpu_torch.serving.fleet as tfleet
import deepspeed_tpu_torch.serving.router as trouter
import deepspeed_tpu_torch.telemetry.bus as tbus
import deepspeed_tpu_torch.utils.health_state as thealth
from deepspeed_tpu.inference.engine import InferenceEngine as JaxEngine
from deepspeed_tpu.models import transformer_lm as jlm
from deepspeed_tpu.ops.sparse_attention.sparse_attention_utils import \
    apply_sparse_attention as jax_sparse
from deepspeed_tpu_torch.models import transformer_lm as tlm
from deepspeed_tpu_torch.module_inject.jax_params import gpt_state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
JAX = {"health": jhealth, "fleet": jfleet, "router": jrouter,
       "admission": jadmission, "bus": jbus}
PORT = {"health": thealth, "fleet": tfleet, "router": trouter,
        "admission": tadmission, "bus": tbus}
SEEDS = (0, 1, 2)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _strip(events):
    return [{k: v for k, v in ev.items() if k != "ts"} for ev in events]


def _bus(pkg):
    bus = pkg["bus"].TelemetryBus(rank=0)
    events = []
    bus.subscribe(events.append)
    return bus, events


def _call(fn, *args, **kw):
    """``fn``'s result, or its exception's type name and message."""
    try:
        return fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - compared across packages
        return ("raised", type(e).__name__, str(e))


def _jsonable(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _jsonable(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    return x


# -- health ------------------------------------------------------------
def _health_ops(seed, n=3, steps=120):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        op = rng.choice(["tick", "beat", "sweep", "down"],
                        p=[0.35, 0.35, 0.22, 0.08])
        ops.append((str(op), int(rng.integers(n)),
                    float(rng.choice([0.5, 1.5, 2.5, 4.0, 7.0]))))
    return ops


def _health_run(pkg, ops, n=3):
    clock = _Clock()
    hooks = []
    cfg = pkg["health"].HealthConfig(suspect_after_s=2.0, down_after_s=6.0,
                                     recover_probes=2)
    sched = pkg["health"].SilenceSchedule(
        n, config=cfg, clock=clock, on_transition=lambda *a: hooks.append(a))
    bus, events = _bus(pkg)
    fh = pkg["fleet"].FleetHealth(n, config=cfg, clock=clock, bus=bus)
    out = []
    for op, i, dt in ops:
        if op == "tick":
            clock.t += dt
        elif op == "beat":
            out.append((sched.heartbeat(i), fh.heartbeat(i)))
        elif op == "sweep":
            sched.sweep()
            fh.sweep()
        else:
            sched.mark_down(i, "eof")
            fh.mark_down(i, "eof")
        out.append((sched.states(), sched.live(), sched.n_live(),
                    sched.state(i), sched.silence(i), fh.states(), fh.live(),
                    fh.n_live(), fh.state(i)))
    bad = [_call(pkg["health"].HealthConfig, **kw) for kw in (
        {"suspect_after_s": 3.0, "down_after_s": 2.0},
        {"recover_probes": 0})]
    return (out, hooks, sched.transitions, fh.transitions, _strip(events),
            bad, _call(pkg["health"].SilenceSchedule, 0))


@pytest.mark.parametrize("seed", SEEDS)
def test_silence_schedule_and_fleet_health(seed):
    ops = _health_ops(seed)
    got = _health_run(PORT, ops)
    assert got == _health_run(JAX, ops)
    assert any(e["kind"] == "serve.replica_down" for e in got[4])
    assert thealth.HEALTHY == "healthy" and tfleet.DOWN == jfleet.DOWN


# -- journal -----------------------------------------------------------
def _journal_ops(seed, steps=150):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        op = str(rng.choice(["submit", "token", "done", "shed", "reassign",
                             "spec", "tick"],
                            p=[0.2, 0.4, 0.06, 0.06, 0.08, 0.1, 0.1]))
        rid = int(rng.integers(12))
        ops.append((op, rid, [int(t) for t in rng.integers(0, 50, 5)],
                    int(rng.integers(1, 6)), int(rng.integers(4)),
                    bool(rng.random() < 0.2), float(rng.random())))
    return ops


def _journal_run(pkg, ops, retain_done):
    clock = _Clock()
    j = pkg["fleet"].RequestJournal(clock=clock, retain_done=retain_done)
    out = []
    for op, rid, prompt, n, replica, done, dt in ops:
        if op == "submit":
            r = _call(j.record_submit, rid, prompt, n, replica=replica,
                      deadline=clock.t + 5, emitted=prompt[:n % 3])
        elif op == "token":
            r = _call(j.record_token, rid, prompt[0], done=done)
        elif op == "done":
            r = _call(j.record_done, rid)
        elif op == "shed":
            r = _call(j.record_shed, rid)
        elif op == "reassign":
            r = _call(j.reassign, rid, replica)
        elif op == "spec":
            r = _call(j.replay_spec, rid)
        else:
            clock.t += dt
            r = None
        out.append((_jsonable(r), j.stats(), j.depths(4), len(j),
                    [e.request_id for e in j.inflight()],
                    [e.request_id for e in j.inflight(replica)],
                    _jsonable(j.entry(rid))))
    return out


@pytest.mark.parametrize("retain_done", [True, False], ids=["retain", "drop"])
@pytest.mark.parametrize("seed", SEEDS)
def test_request_journal(seed, retain_done):
    ops = _journal_ops(seed)
    got = _journal_run(PORT, ops, retain_done)
    assert got == _journal_run(JAX, ops, retain_done)
    assert got[-1][1]["completed"] > 0
    e = tfleet.JournalEntry(request_id=1, prompt=[1], max_new_tokens=4,
                            emitted=[3])
    assert e.remaining_tokens == 3


# -- coordinator ---------------------------------------------------------
def _coord_ops(seed, steps=120):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(steps):
        op = str(rng.choice(["place", "prefill", "token", "kv", "dead",
                             "beat", "tick"],
                            p=[0.25, 0.1, 0.35, 0.08, 0.05, 0.12, 0.05]))
        ops.append((op, int(rng.integers(40)),
                    [int(t) for t in rng.integers(0, 9, rng.integers(1, 12))],
                    int(rng.integers(5)), bool(rng.random() < 0.25),
                    float(rng.choice([0.5, 3.0, 7.0]))))
    return ops


def _coord_run(pkg, ops, roles):
    clock = _Clock()
    bus, events = _bus(pkg)
    router = pkg["router"].PrefixRouter(5, align=4, spill_slack=1)
    coord = _call(pkg["fleet"].FleetCoordinator, router, clock=clock,
                  bus=bus, roles=roles)
    if isinstance(coord, tuple):
        return coord
    out, next_rid = [], 0
    for op, rid, prompt, replica, flag, dt in ops:
        if op == "place":
            r = _call(coord.place, next_rid, prompt, 4,
                      deadline_s=dt if flag else None)
            next_rid += 1
        elif op == "prefill":
            r = _call(coord.place_prefill, prompt)
        elif op == "token":
            r = _call(coord.on_token, rid % max(next_rid, 1), prompt[0],
                      done=flag)
        elif op == "kv":
            r = _call(coord.record_kv_transfer, rid, replica, -1, 1000 + rid,
                      transfer_s=dt if flag else None)
        elif op == "dead":
            r = _call(coord.replica_dead, replica)
        elif op == "beat":
            r = coord.health.heartbeat(replica)
        else:
            clock.t += dt
            r = None
        out.append((_jsonable(r), coord.stats()))
    return out, _strip(events)


ROLES = [None, ["decode"] * 5,
         ["prefill", "decode", "decode", "prefill", "decode"],
         ["prefill"] * 5, ["decode", "gpu", "decode", "decode", "decode"],
         ["decode"] * 3]


@pytest.mark.parametrize("roles", ROLES, ids=["none", "all_decode", "mixed",
                                              "no_decode", "bad_role",
                                              "bad_count"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_coordinator(seed, roles):
    ops = _coord_ops(seed)
    got = _coord_run(PORT, ops, roles)
    assert got == _coord_run(JAX, ops, roles)
    if roles == ROLES[2]:
        kinds = {e["kind"] for e in got[1]}
        assert {"serve.kv_transfer", "serve.replica_down"} <= kinds


# -- router --------------------------------------------------------------
def _router_run(pkg, seed, n=4):
    rng = np.random.default_rng(seed)
    router = pkg["router"].PrefixRouter(n, align=3, spill_slack=1)
    out = []
    for _ in range(150):
        prompt = [int(t) for t in rng.integers(0, 30, rng.integers(1, 8))]
        depths = [int(d) for d in rng.integers(0, 5, n)]
        live = (None if rng.random() < 0.3 else
                [bool(x) for x in rng.random(n) < 0.7])
        if rng.random() < 0.03:
            depths = depths[:-1]
        out.append((router.home(prompt),
                    _call(router.route, prompt, depths, live=live)))
    out.append(router.stats())
    prompts = [[int(t) for t in rng.integers(0, 30, rng.integers(1, 8))]
               for _ in range(60)]
    costs = [int(c) for c in rng.integers(1, 4, len(prompts))]

    def outage(step):
        return [not (20 <= step < 40 and i == 1) for i in range(n)]

    for live, roles in ((None, None), (outage, None),
                        ([True, False, True, True], None),
                        (outage, ["decode", "prefill", "decode", "decode"]),
                        (None, ["prefill"] * n), (None, ["decode", "x"] * 2),
                        ([False] * n, None)):
        r = pkg["router"].PrefixRouter(n, align=3, spill_slack=2)
        out.append((_call(pkg["router"].route_trace, r, prompts, costs,
                          live=live, roles=roles), r.stats()))
    out.append([_call(pkg["router"].PrefixRouter, *a) for a in
                ((0,), (2, 64, -1))])
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_prefix_router_and_route_trace(seed):
    got = _router_run(PORT, seed)
    assert got == _router_run(JAX, seed)
    assert got[-9]["failovers"] > 0 and got[-9]["spills"] > 0
    assert trouter.ROLE_PREFILL == "prefill" and \
        trouter.NoLiveReplicasError.__mro__[1] is RuntimeError


# -- admission -----------------------------------------------------------
ADMISSION = [dict(slo_ttft_p95_s=1.0, window=8, min_samples=3,
                  sample_max_age_s=5.0),
             dict(slo_ttft_p95_s=0.5, window=16, min_samples=4,
                  recover_frac=0.5, drain_to=1, starvation_grace_s=3.0),
             dict(slo_ttft_p95_s=2.0, window=4, min_samples=2,
                  sample_max_age_s=None)]


def _admission_run(pkg, seed, knobs):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    bus = pkg["bus"].TelemetryBus(rank=0)
    ctl = pkg["admission"].SLOAdmissionController(
        pkg["admission"].AdmissionConfig(**knobs), bus=bus, clock=clock)
    out = []
    for _ in range(200):
        op = rng.choice(["ttft", "starve", "decide", "tick"],
                        p=[0.3, 0.04, 0.5, 0.16])
        if op == "ttft":
            bus.publish(pkg["bus"].KIND_SERVE_FIRST_TOKEN, request_id=0,
                        ttft_s=float(rng.choice([0.1, 0.4, 0.9, 1.5, 3.0])))
        elif op == "starve":
            bus.publish(pkg["bus"].KIND_PREFETCH_STARVED, starved_gets=1)
        elif op == "tick":
            clock.t += float(rng.choice([0.5, 2.0, 6.0]))
        else:
            out.append(ctl.decide(int(rng.integers(0, 10)),
                                  int(rng.integers(1, 5))))
        out.append(ctl.stats())
    ctl.close()
    bus.publish(pkg["bus"].KIND_SERVE_FIRST_TOKEN, ttft_s=9.0)
    out.append(ctl.stats())
    bad = [_call(pkg["admission"].AdmissionConfig, **kw) for kw in (
        {"slo_ttft_p95_s": 0}, {"recover_frac": 1.5},
        {"window": 2, "min_samples": 3}, {"sample_max_age_s": 0.0})]
    return out, bad


@pytest.mark.parametrize("knobs", range(len(ADMISSION)),
                         ids=["aging", "starvation", "no_aging"])
@pytest.mark.parametrize("seed", SEEDS)
def test_slo_admission_controller(seed, knobs):
    got = _admission_run(PORT, seed, ADMISSION[knobs])
    assert got == _admission_run(JAX, seed, ADMISSION[knobs])
    decisions = [x for x in got[0] if isinstance(x, tuple)]
    assert {a for a, _ in decisions} == {True, False}
    assert any(x["shedding"] for x in got[0] if isinstance(x, dict))


# -- graceful drain ---------------------------------------------------------
class _FakeScheduler:
    def __init__(self, journal):
        self.journal = journal
        self._lanes_active = 1
        self.drains = []

    def begin_drain(self, reason="drain"):
        self.drains.append(reason)


class _FakeRecorder:
    def __init__(self):
        self.retracted = 0

    def retract_dump(self):
        self.retracted += 1


def _drain_run(pkg):
    clock = _Clock()
    journal = pkg["fleet"].RequestJournal(clock=clock)
    for rid in range(4):
        journal.record_submit(rid, [1, 2, 3 + rid], 3, replica=0)
    journal.record_token(0, 7)
    journal.record_token(1, 7)
    journal.record_token(1, 8)
    journal.record_token(1, 9, done=True)
    journal.record_token(2, 5)
    journal.record_token(2, 6)
    sched = _FakeScheduler(journal)
    bus, events = _bus(pkg)
    recorder = _FakeRecorder()
    drain = pkg["fleet"].GracefulDrain(sched, recorder=recorder, bus=bus)
    chained = []

    def previous(sig, frame):
        chained.append(sig)

    original = signal.signal(signal.SIGTERM, previous)
    try:
        uninstall = drain.install()
        os.kill(os.getpid(), signal.SIGTERM)
        uninstall()
        restored = signal.getsignal(signal.SIGTERM) is previous
    finally:
        signal.signal(signal.SIGTERM, original)
    specs = drain.complete()
    return (sched.drains, chained, restored, specs, _strip(events),
            recorder.retracted, drain.drained)


def test_graceful_drain_on_sigterm():
    assert threading.current_thread() is threading.main_thread()
    got = _drain_run(PORT)
    assert got == _drain_run(JAX)
    drains, chained, restored, specs = got[:4]
    assert drains == ["signal:SIGTERM"] and chained == [signal.SIGTERM]
    assert restored and [s["replay_tokens"] for s in specs] == [[7], [5, 6], []]


def test_reexports_and_names():
    assert sorted(tfleet.__dict__.keys() & {
        "DOWN", "HEALTHY", "RECOVERING", "SUSPECT", "HealthConfig",
        "SilenceSchedule"}) == sorted(jfleet.__dict__.keys() & {
            "DOWN", "HEALTHY", "RECOVERING", "SUSPECT", "HealthConfig",
            "SilenceSchedule"})
    assert tfleet.ReplicaDead(2).replica == 2
    assert str(tfleet.ReplicaDead(2)) == str(jfleet.ReplicaDead(2))
    import deepspeed_tpu_torch.serving as tserving
    assert sorted(tserving.__all__) == sorted(jserving.__all__)


# -- two replica processes, one killed --------------------------------------
WINDOW = {"mode": "local_sliding_window", "block": 16,
          "num_sliding_window_blocks": 3}
TINY = dict(vocab_size=512, n_positions=512, n_embd=64, n_layer=2, n_head=4,
            rotary=True, learned_positions=False)
SERVING = {"slots": 4, "prompt_bucket": 16, "max_pending": 64,
           "prefix_cache": {"promote_after": 2},
           "admission": {"slo_ttft_p95_s": 30.0}, "journal": True}
FLEET_NEW = 8
FLEET_LIMIT_S = 120.0


def _fleet_prompts(seed=0, n=12):
    rng = np.random.default_rng(seed)
    prefix = [int(t) for t in rng.integers(1, 512, 32)]
    out = []
    for i in range(n):
        if i % 2 == 0:
            out.append(prefix + [int(t) for t in rng.integers(
                1, 512, 5 + 16 * int(rng.integers(0, 3)))])
        else:
            out.append([int(t) for t in rng.integers(
                1, 512, int(rng.integers(10, 60)))])
    return out


def test_two_process_fleet_failover_matches_jax():
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    jm = jax_sparse(jlm.GPT(jlm.GPTConfig(**TINY, dtype=jnp.float32)),
                    WINDOW)
    jeng = JaxEngine(jm, {"dtype": "fp32"}, seed=0)
    jeng._materialize(jnp.zeros((1, 48), jnp.int32))
    cfg = tlm.GPTConfig(**TINY, dtype=torch.float32)
    sd = gpt_state_dict_from_jax(jax.device_get(jeng.params), cfg)
    spec = {"gpt": dict(TINY, dtype="float32"), "sparse_attention": WINDOW,
            "state_dict": {k: v.numpy() for k, v in sd.items()},
            "dtype": "fp32", "device": "cpu", "threads": 1}
    # the replicas start while the JAX reference runs
    fleet = chip_smoke.ReplicaFleet(spec, 2, SERVING)
    try:
        prompts = _fleet_prompts()
        sched = jserving.build_serving(jeng, dict(SERVING))
        order = [sched.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
        by_rid = {c.request_id: c.tokens for c in sched.run().completions}
        want = [list(by_rid[r]) for r in order]
        hello = fleet.wait_ready(limit_s=FLEET_LIMIT_S)
        run = fleet.serve(prompts, FLEET_NEW, kill="auto", kill_after=4,
                          align=16, limit_s=FLEET_LIMIT_S)
        launches = fleet.launches()
    finally:
        fleet.close()
    assert len(hello) == 2 and not any(p.is_alive() for p in fleet.procs)
    killed = run["killed"]
    assert killed is not None and run["migrated"]
    assert all(m["from"] == killed and m["to"] != killed
               for m in run["migrated"].values())
    assert run["lost"] == [] and run["sheds"] == []
    assert run["tokens"] == want
    assert run["journal"]["failovers"] == len(run["migrated"])
    assert run["health_transitions"] == [(killed, "healthy", "down")]
    assert launches[killed] is None and not any(launches[1 - killed].values())
