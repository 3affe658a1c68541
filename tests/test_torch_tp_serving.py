"""The continuous-batching scheduler and the serving front door over a
tensor- or expert-parallel engine, against the JAX package's scheduler on
one device and the port's own one-process scheduler.

Two gloo ranks (``test_torch_zero.start_ranks``, this file's worker, one
spawn for every case), each serving its shard of a small model
(``init_inference(mp_size=2)`` or ``ep_size=2``, f32 on the CPU): rank 0
of the group decides, both ranks run the same engine calls. Held:

* a mixed request set through 3 lanes (7 prompts of 5-70 tokens, bucket
  16, 8 new tokens; 3 of them submitted mid-run by rank 0's stream
  callback, one request whose deadline expires in the queue): every
  stream equals the JAX scheduler's on one device token for token, under
  tp 2 (dense cache and a sliding-window ring) and ep 2 (a Mixtral-shaped
  model, no token dropped); the deadline shed on rank 0; only rank 0
  streams, journals and publishes (the other rank's bus sees no
  ``serve.*`` event); the ranks' token digests equal;
* speculative decoding with a tp-2 draft (the same weights): JAX's tokens;
* ``build_serving`` with a prefix cache, SLO admission and a burst: rank 0
  sheds the burst's tail, and the admitted streams and the shed set equal
  the one-process port's under the same config; both ranks' prefix caches
  hit alike;
* ``DisaggServer`` at tp 2: JAX's tokens, and each rank hands off its own
  KV heads (half the one-process hand-off's key and value bytes);
* hand-offs that rank 0 rejects at submit (past the cache, a spent
  deadline, the queue full) raise alike on both ranks, as one process
  raises them, and one that expires in the queue is shed: after ``run``
  no rank keeps a hand-off's cache.

Greedy tokens are compared exactly (f32 on the CPU: the two frameworks and
the tp ranks differ only in the order of sums).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_expert_parallel as ep  # noqa: E402
import test_torch_tensor_parallel as tp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = dict(tp.LLAMA, n_positions=256)
MIXTRAL = dict(ep.MIXTRAL, n_positions=256)
# block 16, 3 window blocks: a 32-slot ring
WINDOW = {"mode": "local_sliding_window", "block": 16,
          "num_sliding_window_blocks": 3}
LENGTHS = (7, 23, 40, 70, 12, 33, 5)
FIRST = 4          # submitted before run; the rest by rank 0's callback
NEW = 8
SLOTS = 3
BUCKET = 16
SPEC_K = 3
# build_serving: a first wave, then a burst that the SLO sheds past depth
# SLOTS (every TTFT of the first wave is over 1 ns)
SERVING = {"slots": SLOTS, "prompt_bucket": BUCKET, "max_pending": 16,
           "prefix_cache": {"promote_after": 1, "budget_bytes": 64 << 20},
           "admission": {"slo_ttft_p95_s": 1e-9, "min_samples": 1,
                         "window": 8},
           "journal": True}
BURST = 8


def prompts(seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 128, size=n)] for n in lengths]


def shared_prompts(n, seed=5):
    """``n`` prompts of 41 tokens sharing their first 32 (one pad offset,
    so the bucket-aligned prefix of 32 columns is one key)."""
    rng = np.random.default_rng(seed)
    head = [int(t) for t in rng.integers(1, 128, size=32)]
    return [head + [int(t) for t in rng.integers(1, 128, size=9)]
            for _ in range(n)]


def _model(fields, ring=False):
    from deepspeed_tpu_torch.models import transformer_lm as tlm
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
        import apply_sparse_attention

    model = tlm.GPT(tlm.GPTConfig(**fields, dtype=torch.float32))
    return apply_sparse_attention(model, WINDOW) if ring else model


def _engine(job, fields=None, ring=None):
    import deepspeed_tpu_torch

    return deepspeed_tpu_torch.init_inference(
        _model(fields or job["fields"], job.get("ring") if ring is None
               else ring),
        dtype="fp32", device="cpu", state_dict=job["sd"], **job["sizes"])


# ---------------------------------------------------------------------------
# the ranks (also the one-process reference: the same functions, no group)
# ---------------------------------------------------------------------------
class _Events:
    """The ``serve.*`` events this process's bus carries."""

    def __init__(self):
        from deepspeed_tpu_torch.telemetry.bus import telemetry_bus

        self.kinds = []
        self.bus = telemetry_bus
        self.bus.subscribe(self.on_event)

    def on_event(self, ev):
        if ev["kind"].startswith("serve."):
            self.kinds.append(ev["kind"])

    def close(self):
        self.bus.unsubscribe(self.on_event)


def _completions(stats):
    return {c.request_id: list(c.tokens) for c in stats.completions}


def run_mixed(engine, draft=None):
    """The mixed request set through the scheduler: FIRST prompts, one
    request whose deadline expires in the queue, the rest submitted by the
    stream callback (rank 0's) as requests finish."""
    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.serving import RequestJournal

    events, journal = _Events(), RequestJournal()
    sched = ContinuousBatchingScheduler(
        engine, slots=SLOTS, prompt_bucket=BUCKET, journal=journal,
        draft_engine=draft, spec_k=SPEC_K if draft is not None else 0)
    ps = prompts()
    later = list(ps[FIRST:])
    streamed = []

    def cb(rid, token, done):
        streamed.append((rid, token))
        if done and later:
            sched.submit(later.pop(0), max_new_tokens=NEW,
                         stream_callback=cb)

    ids = [sched.submit(p, max_new_tokens=NEW, stream_callback=cb)
           for p in ps[:FIRST]]
    ids.append(sched.submit(ps[0], max_new_tokens=NEW, deadline_s=1e-6))
    stats = sched.run()
    events.close()
    return {"ids": ids, "tokens": _completions(stats),
            "streamed": len(streamed), "events": len(events.kinds),
            "journal": len(journal), "deadline_shed": sched.deadline_shed_count,
            "digest": sched._digest.hexdigest(), "leader": sched.leader}


def run_front_door(engine):
    """``build_serving`` (prefix cache, admission, journal): a first wave
    of 3, then a burst of BURST submitted at once."""
    from deepspeed_tpu_torch.inference.scheduler import AdmissionRejected
    from deepspeed_tpu_torch.serving import build_serving

    sched = build_serving(engine, dict(SERVING))
    ps = shared_prompts(3 + BURST)
    for p in ps[:3]:
        sched.submit(p, max_new_tokens=NEW)
    first = _completions(sched.run())
    shed = []
    for i, p in enumerate(ps[3:]):
        try:
            sched.submit(p, max_new_tokens=NEW)
        except AdmissionRejected as e:
            shed.append((i, e.reason))
    second = _completions(sched.run())
    pc = sched.prefix_cache
    sched.admission_controller.close()
    return {"first": first, "second": second, "shed": shed,
            "prefix": {k: pc.stats()[k] for k in ("hits", "insertions",
                                                   "entries", "evictions")}}


def run_disagg(engine):
    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.models.transformer_lm import kv_cache
    from deepspeed_tpu_torch.serving import DisaggServer, PrefillWorker

    sched = ContinuousBatchingScheduler(engine, slots=SLOTS,
                                        prompt_bucket=BUCKET)
    server = DisaggServer(sched, [PrefillWorker(engine,
                                                prompt_bucket=BUCKET)])
    ids = [server.submit(p, max_new_tokens=NEW) for p in prompts()]
    stats = server.run()
    cache = kv_cache(engine.module.cache_config, 1, torch.device("meta"))
    return {"ids": ids, "tokens": _completions(stats),
            "handoff_bytes": server.handoff_bytes,
            "kv_bytes_per_lane": sum(t.numel() * t.element_size()
                                     for t in [*cache.key, *cache.value])}


# DisaggServer.submit keywords and rank 0's outcome, max_pending 3
SHED_SUBMITS = (({}, "ok"), ({"max_new_tokens": 300}, "ValueError"),
                ({"deadline_s": 0}, "DeadlineExceededError"),
                ({"deadline_s": 1e-6}, "ok"), ({}, "ok"),
                ({}, "QueueFullError"))


def run_disagg_shed(engine):
    """``SHED_SUBMITS`` through a ``DisaggServer``; each submit's outcome,
    the hand-offs the scheduler keeps for the other ranks before and after
    ``run``, and the served streams."""
    from deepspeed_tpu_torch.inference.scheduler import \
        ContinuousBatchingScheduler
    from deepspeed_tpu_torch.serving import DisaggServer, PrefillWorker

    sched = ContinuousBatchingScheduler(engine, slots=SLOTS,
                                        prompt_bucket=BUCKET, max_pending=3)
    server = DisaggServer(sched, [PrefillWorker(engine,
                                                prompt_bucket=BUCKET)])
    outcomes, ids = [], {}
    for i, (kw, _) in enumerate(SHED_SUBMITS):
        try:
            ids[server.submit(prompts()[i], **dict(
                {"max_new_tokens": NEW}, **kw))] = i
            outcomes.append("ok")
        except (RuntimeError, ValueError) as e:
            outcomes.append(type(e).__name__)
    kept = len(sched._handoffs)
    stats = server.run()
    return {"outcomes": outcomes, "kept_before_run": kept,
            "kept_after_run": len(sched._handoffs),
            "deadline_shed": sched.deadline_shed_count,
            "tokens": {ids[c.request_id]: list(c.tokens)
                       for c in stats.completions}}


def _serve_job(job, rank):
    engine = _engine(job)
    if job["kind"] == "mixed":
        return run_mixed(engine)
    if job["kind"] == "spec":
        return run_mixed(engine, draft=_engine(job))
    if job["kind"] == "front_door":
        return run_front_door(engine)
    if job["kind"] == "disagg_shed":
        return run_disagg_shed(engine)
    return run_disagg(engine)


def _worker(argv):
    spec, rank, world, url, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    from datetime import timedelta

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.mesh import reset_default_topology

    torch.set_num_threads(1)
    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          timeout=timedelta(seconds=tp.GROUP_TIMEOUT_S),
                          device_type="cpu")
    results = {}
    for job in torch.load(spec, weights_only=False):
        reset_default_topology()
        results[job["name"]] = _serve_job(job, rank)
    torch.save(results, out)
    comm.destroy_distributed()
    return 0


# ---------------------------------------------------------------------------
# the parent: JAX on one device, and the port in one process
# ---------------------------------------------------------------------------
def jax_scheduler_tokens(fields, ring=False):
    """The JAX scheduler's streams of ``prompts()`` (3 lanes, bucket 16) on
    one device, and the weights it drew (port names)."""
    import jax.numpy as jnp

    import deepspeed_tpu
    from deepspeed_tpu.inference.scheduler import \
        ContinuousBatchingScheduler as JaxScheduler
    from deepspeed_tpu.models import transformer_lm as jlm
    from deepspeed_tpu.ops.sparse_attention.sparse_attention_utils import \
        apply_sparse_attention as jax_sparse

    jm = jlm.GPT(jlm.GPTConfig(**fields, dtype=jnp.float32))
    if ring:
        jm = jax_sparse(jm, WINDOW)
    jeng = deepspeed_tpu.init_inference(jm, dtype="fp32", seed=0)
    jeng._materialize(jnp.zeros((1, 4 * BUCKET), jnp.int32))
    sched = JaxScheduler(jeng, slots=SLOTS, prompt_bucket=BUCKET)
    for p in prompts():
        sched.submit(p, max_new_tokens=NEW)
    got = {c.request_id: list(c.tokens) for c in sched.run().completions}
    return [got[i] for i in range(len(LENGTHS))], tp.port_weights(jeng,
                                                                  fields)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from test_torch_zero import start_ranks

    want, sd = {}, {}
    for name, fields, ring in (("llama", LLAMA, False),
                               ("ring", LLAMA, True),
                               ("mixtral", MIXTRAL, False)):
        want[name], sd[name] = jax_scheduler_tokens(fields, ring)
    tp2, ep2 = {"mp_size": 2}, {"ep_size": 2}
    jobs = [dict(name="mixed_tp", kind="mixed", fields=LLAMA, sd=sd["llama"],
                 sizes=tp2),
            dict(name="mixed_ring_tp", kind="mixed", fields=LLAMA,
                 sd=sd["ring"], sizes=tp2, ring=True),
            dict(name="mixed_ep", kind="mixed", fields=MIXTRAL,
                 sd=sd["mixtral"], sizes=ep2),
            dict(name="spec_tp", kind="spec", fields=LLAMA, sd=sd["llama"],
                 sizes=tp2),
            dict(name="front_door_tp", kind="front_door", fields=LLAMA,
                 sd=sd["llama"], sizes=tp2),
            dict(name="disagg_tp", kind="disagg", fields=LLAMA,
                 sd=sd["llama"], sizes=tp2),
            dict(name="disagg_shed_tp", kind="disagg_shed", fields=LLAMA,
                 sd=sd["llama"], sizes=tp2)]
    ranks = start_ranks(jobs, tmp_path_factory.mktemp("tp_serving"), 2,
                        worker=__file__)
    # the port in one process, meanwhile
    one = {"mixed": run_mixed(_engine({"fields": LLAMA, "sd": sd["llama"],
                                       "sizes": {}})),
           "front_door": run_front_door(_engine(
               {"fields": LLAMA, "sd": sd["llama"], "sizes": {}})),
           "disagg": run_disagg(_engine({"fields": LLAMA, "sd": sd["llama"],
                                         "sizes": {}})),
           "disagg_shed": run_disagg_shed(_engine(
               {"fields": LLAMA, "sd": sd["llama"], "sizes": {}}))}
    return dict(ranks=ranks, want=want, one=one)


def _streams(run):
    """The mixed set's streams in prompt order (request ids: FIRST
    prompts, the shed request, then the callback's submissions)."""
    order = list(range(FIRST)) + list(range(FIRST + 1, len(LENGTHS) + 1))
    return [run["tokens"][i] for i in order]


@pytest.mark.parametrize("case,model", [("mixed_tp", "llama"),
                                        ("mixed_ring_tp", "ring"),
                                        ("mixed_ep", "mixtral"),
                                        ("spec_tp", "llama")])
def test_streams_match_jax_on_every_rank(runs, case, model):
    """Every rank's streams are the JAX scheduler's; the request that
    expired in the queue was shed, and rank 0's ids are the one-process
    scheduler's."""
    for rank, r in enumerate(runs["ranks"]):
        got = r[case]
        assert _streams(got) == runs["want"][model], rank
        assert set(got["tokens"]) == set(range(len(LENGTHS) + 1)) - {FIRST}
    r0 = runs["ranks"][0][case]
    assert r0["ids"] == runs["one"]["mixed"]["ids"]
    assert r0["deadline_shed"] == 1


@pytest.mark.parametrize("case", ["mixed_tp", "mixed_ring_tp", "mixed_ep"])
def test_only_rank_0_streams_journals_and_publishes(runs, case):
    r0, r1 = (r[case] for r in runs["ranks"])
    assert r0["leader"] and not r1["leader"]
    n_tokens = NEW * len(LENGTHS)
    assert r0["streamed"] == n_tokens and r1["streamed"] == 0
    assert r0["journal"] == len(LENGTHS) + 1 and r1["journal"] == 0
    assert r0["events"] > 0 and r1["events"] == 0
    # the other rank submitted nothing itself: its ids are None
    assert r1["ids"] == [None] * (FIRST + 1)
    assert r0["digest"] == r1["digest"]


def test_front_door_sheds_on_rank_0_as_one_process(runs):
    """The burst's tail is shed by rank 0's admission controller as one
    process sheds it; the admitted streams are the one-process port's, and
    both ranks' prefix caches hit and promote alike."""
    one = runs["one"]["front_door"]
    r0, r1 = (r["front_door_tp"] for r in runs["ranks"])
    assert r0["shed"] == one["shed"] and len(one["shed"]) == BURST - SLOTS
    assert all(reason == "slo_shed" for _, reason in r0["shed"])
    assert r1["shed"] == []
    for r in (r0, r1):
        assert r["first"] == one["first"] and r["second"] == one["second"]
    assert r0["prefix"] == r1["prefix"]
    assert r0["prefix"]["hits"] == one["prefix"]["hits"] > 0


def test_disagg_hands_off_each_ranks_kv_heads(runs):
    one = runs["one"]["disagg"]
    for r in runs["ranks"]:
        got = r["disagg_tp"]
        assert _completion_list(got) == runs["want"]["llama"]
        assert 2 * got["kv_bytes_per_lane"] == one["kv_bytes_per_lane"]
        assert got["handoff_bytes"] < one["handoff_bytes"]
    assert _completion_list(one) == runs["want"]["llama"]


def test_disagg_rejected_and_shed_handoffs_leave_no_cache(runs):
    """Rank 0's outcome of each hand-off is the group's (the one-process
    server's, exception types included); the other rank keeps the caches
    of the accepted hand-offs only, and none once ``run`` admitted or shed
    them (the expired one shed from the queue)."""
    one = runs["one"]["disagg_shed"]
    want = [o for _, o in SHED_SUBMITS]
    assert one["outcomes"] == want
    served = [i for i, o in enumerate(want) if o == "ok" and
              "deadline_s" not in SHED_SUBMITS[i][0]]
    r0, r1 = (r["disagg_shed_tp"] for r in runs["ranks"])
    assert r1["kept_before_run"] == want.count("ok")
    for r in (one, r0, r1):
        assert r["outcomes"] == want
        assert r["kept_after_run"] == 0
        assert r["tokens"] == {i: runs["want"]["llama"][i] for i in served}
    assert r0["deadline_shed"] == one["deadline_shed"] == 2


def _completion_list(run):
    return [run["tokens"][i] for i in range(len(LENGTHS))]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(_worker(sys.argv[2:]))
