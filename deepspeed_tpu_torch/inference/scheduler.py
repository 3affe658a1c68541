"""Continuous batching over the KV-cache decode path (counterpart of
``deepspeed_tpu/inference/scheduler.py``, the whole module).

``InferenceEngine.generate`` serves one fixed batch from start to finish:
every sequence waits for the slowest. The scheduler instead keeps a
fixed-shape decode batch of ``slots`` lanes and swaps sequences through
them:

* the decode step is one ``[slots, 1]`` call of the engine's decode runs
  (``InferenceEngine._decoder(slots)``), a CUDA graph on the card, so
  admissions and completions never change its shape;
* a finished sequence's lane is refilled from the queue at once: admission
  runs the exact (chunked when needed) prefill of one prompt on the
  engine's batch-1 cache and splices that row into the lane
  (``KVCache.splice``, in place: the graphs read the live buffers), which
  the caches' per-row clocks allow;
* completion is per sequence (EOS or the request's ``max_new_tokens``),
  and every emitted token fires the request's stream callback.

A free lane keeps decoding garbage (rows are independent, and a lane that
sees no key gets no weight), and the next admission overwrites its row.
Unlike JAX's ``mode="drop"`` writes, a write past the cache would be out
of bounds on the card, so a free lane whose clock nears the capacity is
emptied first (``KVCache.reset_rows``).

Prompts are left-padded to a ``prompt_bucket`` multiple, which bounds the
prefill graphs (a multiple of the layout block for ring models, so whole
blocks shift and the window's visibility is exact; see the JAX module's
docstring for why left padding is exact for rotary, ALiBi and learned
positions). Leading-global layouts keep their globals at physical slots,
so left padding moves real tokens out of them: serve those through
``generate``, or with a bucket equal to the prompt length.

Speculative decoding (``draft_engine``, ``spec_k``): per step the draft
proposes ``spec_k`` greedy tokens per lane, the target verifies them in one
``[slots, k+1]`` pass (``InferenceEngine._verify_greedy``), and both caches
step back past each lane's first mismatch (``KVCache.rewind``, a selective
per-slot restore from a snapshot taken before the pass). Every emitted
token is a target argmax given the emitted prefix, so the stream is
exactly sequential greedy.

The scheduler publishes JAX's telemetry events on the process-global bus
(``telemetry/bus.py``), with JAX's payload keys: ``serve.admit`` per
admission, ``serve.first_token`` per request that is not a replay (the
admission controller's TTFT samples), ``serve.evict`` per completion,
``serve.stats`` per loop iteration, ``serve.shed`` and
``serve.deadline_shed`` per rejection, ``serve.drain`` when admission
closes and ``serve.spec_accept`` per speculative step. The counters those
events carry (``shed_count``, ``deadline_shed_count``, ``spec_proposed``,
``spec_accepted``, ``ServingStats.decode_steps``, ``_lanes_active``) stay.
The front-door hooks (``prefix_cache``, ``admission_controller``,
``reject_callback``, ``journal``, ``health_provider``) are duck-typed, as
in JAX.

Over a tensor- or expert-parallel engine (one process per card; JAX serves
any engine under its topology from one controller) the collectives inside
the prefill and decode graphs meet only if every rank makes the same
engine calls in the same order. So rank 0 of the engine's tp x ep group
decides and every rank executes: rank 0 owns the queue, the clock,
admission, deadlines and the prefix cache's lookups and promotions; each
host decision the engine calls depend on is broadcast from it over the
group's gloo group (``decide``, ``comm.broadcast_object``): once per loop
iteration the stop and drain state, and once per admission the request
taken (or none). The tokens every rank computes from the gathered logits
are equal, so each rank uses its own; each hashes them, and the digests
ride on the iteration's stop decision (``_agree``), so a divergence raises
on every rank one step after it. Every rank builds the scheduler and calls
``run`` alike. A plain ``submit`` on the other ranks only checks its
arguments and returns None (rank 0's stream callbacks submit on rank 0
alone); a ``kv_handoff`` is submitted on every rank (each holds its own KV
heads), and rank 0's outcome, its id or its rejection, is the group's.
Only rank 0 streams tokens, journals and publishes events.
"""

import hashlib
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.inference.engine import continuation_chunk_spans
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import \
    ring_engaged
from deepspeed_tpu_torch.telemetry.bus import (
    KIND_SERVE_ADMIT, KIND_SERVE_DEADLINE_SHED, KIND_SERVE_DRAIN,
    KIND_SERVE_EVICT, KIND_SERVE_FIRST_TOKEN, KIND_SERVE_SHED,
    KIND_SERVE_SPEC_ACCEPT, KIND_SERVE_STATS, publish)


class AdmissionRejected(RuntimeError):
    """Base for 429-style rejections; carries a machine-readable
    reason."""

    def __init__(self, message: str, reason: str = "rejected"):
        super().__init__(message)
        self.reason = reason


class QueueFullError(AdmissionRejected):
    """submit() hit the scheduler's ``max_pending`` bound."""

    def __init__(self, message: str):
        super().__init__(message, reason="queue_full")


class RequestShedError(AdmissionRejected):
    """The admission controller shed this request to hold its SLO."""

    def __init__(self, message: str, reason: str = "slo_shed"):
        super().__init__(message, reason=reason)


class DeadlineExceededError(AdmissionRejected):
    """The request's deadline expired before it could be served."""

    def __init__(self, message: str):
        super().__init__(message, reason="deadline")


class DrainingError(AdmissionRejected):
    """Admission is closed: the scheduler is draining."""

    def __init__(self, message: str):
        super().__init__(message, reason="draining")


@dataclass
class Request:
    """One sequence to serve: prompt token ids plus completion rules."""
    prompt: Sequence[int]
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    # called as callback(request_id, token_id, done) per emitted token
    stream_callback: Optional[Callable[[int, int, bool], None]] = None
    request_id: Optional[int] = None
    # absolute time.monotonic() by which the first token must be on its
    # way; an expired request is shed from the queue, never a lane
    t_deadline: Optional[float] = None
    # failover replay: tokens this request already emitted elsewhere.
    # Admission prefills the prompt at its bucket, then the emitted tokens
    # as continuation passes (continuation_chunk_spans), and decoding goes
    # on under the original max_new_tokens budget: greedy decode is a pure
    # function of the tokens so far, so the continuation is identical
    replay_tokens: Optional[List[int]] = None
    # a prefill already run elsewhere at the same prompt_bucket: a
    # (first_token, one-row KVCache) pair that admission splices into a
    # lane instead of prefilling
    kv_handoff: Optional[Any] = None


@dataclass
class Completion:
    """Result and latency of one served request."""
    request_id: int
    tokens: List[int]
    prompt_len: int
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    @property
    def ttft_s(self) -> float:
        """Time to first token from submission (queue wait included)."""
        return self.t_first_token - self.t_submit

    @property
    def per_token_s(self) -> float:
        """Mean inter-token latency after the first token."""
        n = len(self.tokens)
        if n <= 1:
            return 0.0
        return (self.t_done - self.t_first_token) / (n - 1)


@dataclass
class _Lane:
    req: Request
    comp: Completion
    emitted: int = 0


@dataclass
class ServingStats:
    completions: List[Completion] = field(default_factory=list)
    wall_s: float = 0.0
    decode_steps: int = 0

    def summary(self) -> Dict[str, Any]:
        ttfts = sorted(c.ttft_s for c in self.completions)
        pts = [c.per_token_s for c in self.completions if len(c.tokens) > 1]
        total_tokens = sum(len(c.tokens) for c in self.completions)

        def pct(xs, q):
            if not xs:
                return 0.0
            return float(xs[min(len(xs) - 1, int(q * len(xs)))])

        return {
            "num_sequences": len(self.completions),
            "total_generated_tokens": total_tokens,
            "wall_s": self.wall_s,
            "aggregate_tokens_per_s": (total_tokens / self.wall_s
                                       if self.wall_s > 0 else 0.0),
            "ttft_s": {"mean": float(np.mean(ttfts)) if ttfts else 0.0,
                       "p50": pct(ttfts, 0.50), "p95": pct(ttfts, 0.95)},
            "per_token_ms": {
                "mean": float(np.mean(pts)) * 1e3 if pts else 0.0,
                "p50": pct(sorted(pts), 0.50) * 1e3,
                "p95": pct(sorted(pts), 0.95) * 1e3},
            "decode_steps": self.decode_steps,
        }


def hbm_bytes(device, override_gib: Optional[float] = None):
    """``(bytes or None, source)``: the card's memory
    (``torch.cuda.get_device_properties``), an override, or None on the
    CPU (JAX ``telemetry/memory.hbm_bytes``, whose table names TPUs)."""
    if override_gib:
        return int(override_gib * (1 << 30)), "config override"
    device = torch.device(device)
    if device.type != "cuda":
        return None, f"no device memory figure for {device.type}"
    props = torch.cuda.get_device_properties(device)
    return int(props.total_memory), f"torch.cuda ({props.name})"


class ContinuousBatchingScheduler:
    """Slot-based continuous batching over an ``InferenceEngine``.

    ``submit()`` requests (before or during ``run()``: a stream callback may
    submit follow-ups), then ``run()`` drives admissions, the fixed-shape
    decode step, per-sequence completion and the stream callbacks until the
    queue drains. Returns the completions in finish order. The scheduler
    uses the engine's caches of batch 1 (admissions) and ``slots`` (the
    lanes); a ``generate`` call between runs may reuse them, not one made
    during a run.
    """

    def __init__(self, engine, slots: int = 8,
                 prompt_bucket: Optional[int] = None,
                 temperature: float = 0.0,
                 eos_token_id: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 prefix_cache=None,
                 admission_controller=None,
                 reject_callback: Optional[Callable] = None,
                 journal=None,
                 health_provider=None,
                 draft_engine=None,
                 spec_k: int = 0):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        # the serving group: the tp x ep ranks of a parallel engine, whose
        # rank 0 decides (None: one card)
        par, dpar = (getattr(getattr(eng, "module", None), "parallel", None)
                     for eng in (engine, draft_engine))
        if draft_engine is not None and (par is None) != (dpar is None) or (
                par is not None and dpar is not None
                and (par.tp, par.ep) != (dpar.tp, dpar.ep)):
            raise ValueError("the draft_engine must run at the target's tp "
                             "and ep (the same serving group)")
        self._axes = None if par is None else ("ep", "tp")
        self.leader = par is None or (par.tp_rank == 0 and par.ep_rank == 0)
        # the other ranks' hand-offs, by rank 0's request id
        self._handoffs: Dict[int, Any] = {}
        self._digest = hashlib.blake2b(digest_size=16)
        self.engine = engine
        self.slots = int(slots)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.max_pending = None if max_pending is None else int(max_pending)
        self.prefix_cache = prefix_cache
        self.admission_controller = admission_controller
        self.reject_callback = reject_callback
        self.journal = journal
        self.health_provider = health_provider
        self.draft_engine = draft_engine
        self.spec_k = int(spec_k)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.shed_count = 0
        self.deadline_shed_count = 0
        self._draining = False
        self.drain_reason: Optional[str] = None
        self._lanes_active = 0
        # True runs every engine call uncaptured (a reference for the
        # graphs)
        self.eager = False
        self._mcfg = engine.module.config

        self._ring = ring_engaged(self._mcfg)
        if prompt_bucket is None:
            prompt_bucket = self._ring[2] if self._ring is not None else 64
        if self._ring is not None and prompt_bucket % self._ring[2] != 0:
            raise ValueError(
                f"prompt_bucket {prompt_bucket} must be a multiple of the "
                f"ring layout block {self._ring[2]}: admission prefill "
                "left-pads to the bucket, and only whole-block shifts "
                "preserve the training window visibility exactly")
        self.prompt_bucket = int(prompt_bucket)

        # hard capacity for models whose decode cannot stream (dense cache
        # or learned positions): prompt + generation must fit n_positions
        self._max_pos = self._mcfg.n_positions
        self._streaming = (self._ring is not None and
                           not self._mcfg.learned_positions)

        # speculative decoding's preconditions, all config properties
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if (draft_engine is None) != (self.spec_k == 0):
            raise ValueError(
                "speculative decoding needs BOTH a draft_engine and "
                f"spec_k >= 1 (got draft_engine="
                f"{'set' if draft_engine is not None else 'None'}, "
                f"spec_k={spec_k})")
        self._draft_mcfg = None
        self._draft_ring = None
        if draft_engine is not None:
            if self.temperature != 0.0:
                raise ValueError(
                    "speculative decoding here is EXACT-greedy only "
                    "(accepted tokens are target argmaxes); temperature "
                    f"must be 0.0, got {temperature}")
            if draft_engine is engine:
                # the two would share one engine's caches
                raise ValueError("the draft_engine must be another engine "
                                 "than the target (one of its own weights "
                                 "is fine)")
            if self._ring is not None:
                blk = self._ring[2]
                if int(self._mcfg.kv_cache_slack_blocks or 0) < 1:
                    raise ValueError(
                        "speculative decoding over a ring KV cache needs "
                        "kv_cache_slack_blocks >= 1 on the TARGET model: "
                        "the k+1-column verify pass writes every column "
                        "before attention reads, and without a slack "
                        "block an unaligned pass can evict entries its "
                        "own earlier columns still need "
                        "(ops/sparse_attention ring_storage_len)")
                if self.spec_k > blk:
                    raise ValueError(
                        f"spec_k ({spec_k}) must be <= the ring layout "
                        f"block ({blk}): one slack block makes passes of "
                        "at most `block` tokens exact")
            self._draft_mcfg = draft_engine.module.config
            self._draft_ring = ring_engaged(self._draft_mcfg)
            if self._draft_ring is not None and \
                    self.prompt_bucket % self._draft_ring[2] != 0:
                raise ValueError(
                    f"prompt_bucket {self.prompt_bucket} must be a "
                    f"multiple of the DRAFT model's ring block "
                    f"({self._draft_ring[2]}): admission prefills the "
                    "draft cache at the same bucket")

        self._pending: deque = deque()
        self._next_id = 0
        self._kv_stats_static = None
        if prefix_cache is not None and self._axes is not None:
            # every rank's cache holds the same keys: rank 0's budget, and
            # only rank 0 publishes
            prefix_cache.budget_bytes = self.decide(prefix_cache.budget_bytes)
            prefix_cache.events = self.leader

    # ------------------------------------------------------------------
    def decide(self, value):
        """Rank 0's ``value`` on every rank of the serving group
        (``value`` itself on one card): each host decision that the engine
        calls depend on goes through here, so every rank makes the same
        calls in the same order and the collectives inside them meet."""
        if self._axes is None:
            return value
        return comm.broadcast_object(value if self.leader else None,
                                     self._axes)

    def _publish(self, kind, **payload):
        if self.leader:
            publish(kind, **payload)

    def _hash(self, tokens: np.ndarray) -> np.ndarray:
        """``tokens`` (this rank's), hashed into the run's digest over a
        serving group (``_agree``)."""
        if self._axes is not None:
            self._digest.update(np.asarray(tokens, np.int64).tobytes())
        return tokens

    def _agree(self, stop: bool):
        """Rank 0's ``(stop, draining)`` on every rank, once per loop
        iteration. Each rank's digest of the tokens it computed so far
        rides along: a divergence raises on every rank at the next
        iteration, before the ranks' lanes can part."""
        if self._axes is None:
            return stop, self._draining
        states = comm.all_gather_object(
            (stop, self._draining, self._digest.hexdigest()), self._axes)
        if len({d for _, _, d in states}) > 1:
            raise RuntimeError(
                "the serving group's ranks computed different tokens "
                f"(digests {[d for _, _, d in states]})")
        return states[0][:2]

    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None,
               stream_callback: Optional[Callable] = None,
               deadline_s: Optional[float] = None,
               replay_tokens: Optional[Sequence[int]] = None,
               kv_handoff: Optional[Any] = None) -> int:
        """Queue one request; returns its request id.

        Raises ``QueueFullError`` when the queue is at ``max_pending``,
        ``RequestShedError`` when the admission controller sheds,
        ``DeadlineExceededError`` when ``deadline_s`` is already spent and
        ``DrainingError`` once ``begin_drain`` closed admission (all
        ``AdmissionRejected``); the reject callback fires first.

        ``deadline_s`` is a relative first-token budget: a request still
        queued when it expires is shed from the queue. ``replay_tokens``
        marks a failover replay (``Request.replay_tokens``): the stream
        callback fires only for new tokens. ``kv_handoff`` is a prefill
        run elsewhere (``Request.kv_handoff``); it excludes
        ``replay_tokens``.
        """
        prompt = list(int(t) for t in prompt)
        if not prompt:
            raise ValueError("an empty prompt cannot seed generation")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if kv_handoff is not None and replay_tokens:
            raise ValueError(
                "kv_handoff and replay_tokens are mutually exclusive: a "
                "failover replay must re-run its emitted tokens, which a "
                "prefill hand-off has not seen")
        replay = [int(t) for t in replay_tokens] if replay_tokens else []
        if replay and len(replay) >= max_new_tokens:
            raise ValueError(
                f"replay of {len(replay)} tokens exhausts the "
                f"max_new_tokens budget ({max_new_tokens}) — the request "
                "already finished; do not replay it")
        if self._axes is not None and kv_handoff is not None:
            # a hand-off is submitted on every rank of the serving group
            # (each holds its own KV heads): rank 0's outcome, its request
            # id or its rejection, is every rank's
            rid = err = None
            if self.leader:
                try:
                    rid = self._enqueue(prompt, max_new_tokens, eos_token_id,
                                        stream_callback, deadline_s, replay,
                                        kv_handoff)
                except (AdmissionRejected, ValueError) as exc:
                    err = exc
            rid, err = self.decide((rid, err))
            if err is not None:
                raise err
            if not self.leader:
                self._handoffs[rid] = kv_handoff
            return rid
        if not self.leader:
            self._check_capacity(len(prompt), max_new_tokens)
            return None
        return self._enqueue(prompt, max_new_tokens, eos_token_id,
                             stream_callback, deadline_s, replay, kv_handoff)

    def _enqueue(self, prompt, max_new_tokens, eos_token_id, stream_callback,
                 deadline_s, replay, kv_handoff) -> int:
        """``submit``'s admission checks and queueing (rank 0's)."""
        depth = len(self._pending)
        if self._draining:
            self._reject(DrainingError(
                "admission is closed: the scheduler is draining "
                f"({self.drain_reason})"), depth)
        if deadline_s is not None and deadline_s <= 0:
            self._reject(DeadlineExceededError(
                f"deadline_s={deadline_s} already expired at submit"),
                depth, kind=KIND_SERVE_DEADLINE_SHED)
        if self.max_pending is not None and depth >= self.max_pending:
            self._reject(QueueFullError(
                f"admission queue is full ({depth}/{self.max_pending} "
                "pending); retry after the scheduler drains"), depth)
        if self.admission_controller is not None:
            admit, reason = self.admission_controller.decide(
                queue_depth=depth, slots=self.slots)
            if not admit:
                self._reject(RequestShedError(
                    f"request shed by admission control: {reason}"), depth)
        self._check_capacity(len(prompt), max_new_tokens)
        rid = self._next_id
        self._next_id += 1
        now = time.monotonic()
        req = Request(prompt=prompt, max_new_tokens=int(max_new_tokens),
                      eos_token_id=(self.eos_token_id if eos_token_id is None
                                    else eos_token_id),
                      stream_callback=stream_callback, request_id=rid,
                      t_deadline=(None if deadline_s is None
                                  else now + float(deadline_s)),
                      replay_tokens=replay or None,
                      kv_handoff=kv_handoff)
        if self.journal is not None:
            self.journal.record_submit(
                rid, prompt, req.max_new_tokens,
                deadline=req.t_deadline, emitted=replay)
        self._pending.append((req, now))
        return rid

    def _check_capacity(self, n_prompt: int, max_new_tokens: int) -> None:
        """The prompt's bucket and its new tokens fit the cache (checked
        on every rank)."""
        bucketed = self._bucketed_len(n_prompt)
        if not self._streaming and \
                bucketed + max_new_tokens > self._max_pos:
            raise ValueError(
                f"bucketed prompt ({bucketed}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the KV cache capacity "
                f"(n_positions={self._max_pos})")
        if self.spec_k and not self._streaming and \
                bucketed + max_new_tokens + self.spec_k > self._max_pos:
            # a verify pass writes spec_k columns past the last token kept;
            # JAX drops writes past the cache (mode="drop"), the port's
            # would be out of bounds
            raise ValueError(
                f"bucketed prompt ({bucketed}) + max_new_tokens "
                f"({max_new_tokens}) + spec_k ({self.spec_k}) exceeds the "
                f"KV cache capacity (n_positions={self._max_pos})")

    def _reject(self, exc: AdmissionRejected, depth: int, kind=None):
        """Count the shed, publish ``serve.shed`` (or ``kind``), fire the
        429 callback, raise ``exc``."""
        self.shed_count += 1
        if isinstance(exc, DeadlineExceededError):
            self.deadline_shed_count += 1
        self._publish(kind or KIND_SERVE_SHED, severity="warning",
                      reason=exc.reason, queue_depth=depth,
                      shed_total=self.shed_count)
        if self.reject_callback is not None:
            try:
                self.reject_callback(None, exc.reason)
            except Exception:  # the callback must not mask the rejection
                pass
        raise exc

    def begin_drain(self, reason: str = "drain") -> None:
        """Close admission. Safe from a signal handler: sets a flag and
        publishes one ``serve.drain``. ``run()`` finishes the lanes already
        decoding and returns with the queue intact for the journal's
        hand-off."""
        if self._draining:
            return
        self._draining = True
        self.drain_reason = str(reason)
        self._publish(KIND_SERVE_DRAIN, severity="warning", phase="begin",
                      reason=self.drain_reason,
                      queue_depth=len(self._pending),
                      lanes_active=self._lanes_active)

    @property
    def draining(self) -> bool:
        return self._draining

    def _shed_expired(self, req: Request, t_submit: float) -> None:
        """Drop one queue entry whose deadline passed before a lane freed
        up: it never occupies a lane or runs a prefill."""
        now = time.monotonic()
        self.deadline_shed_count += 1
        self._publish(KIND_SERVE_DEADLINE_SHED, severity="warning",
                      request_id=req.request_id, waited_s=now - t_submit,
                      late_s=now - req.t_deadline,
                      queue_depth=len(self._pending),
                      deadline_shed_total=self.deadline_shed_count)
        if self.journal is not None:
            self.journal.record_shed(req.request_id)
        if self.reject_callback is not None:
            try:
                self.reject_callback(req.request_id, "deadline")
            except Exception:
                pass

    def _bucketed_len(self, n: int) -> int:
        b = self.prompt_bucket
        return ((n + b - 1) // b) * b

    # ------------------------------------------------------------------
    def _lane_cache(self, eng):
        """``eng``'s ``[slots]``-lane cache, emptied."""
        return eng._decoder(self.slots).cache.reset()

    def _prefill(self, eng, ids, mask):
        return eng._chunked_prefill(ids, mask, eager=self.eager)

    def _prefill_more(self, eng, mcfg, ids, mask, cache, start, end):
        """Continuation passes of columns ``[start, end)`` of ``ids``
        (the columns ``[start, end)`` of the sequence) on ``cache``."""
        logits = None
        for s, e in continuation_chunk_spans(mcfg, start, end):
            logits, cache = eng._prefill_more(
                ids[:, s - start:e - start], mask[:, s - start:e - start],
                cache, eager=self.eager)
        return logits, cache

    def _padded(self, req: Request):
        """The prompt left-padded to its bucket, ``[1, Lp]`` ids and mask on
        the engine's device (as numpy, for the prefix cache's key)."""
        Lp = self._bucketed_len(len(req.prompt))
        ids = np.zeros((1, Lp), np.int64)
        mask = np.zeros((1, Lp), bool)
        ids[0, Lp - len(req.prompt):] = req.prompt
        mask[0, Lp - len(req.prompt):] = True
        return ids, mask

    def _replay(self, eng, mcfg, req: Request, Lp: int, cache):
        E = len(req.replay_tokens)
        dev = eng.device
        rep_ids = torch.tensor([req.replay_tokens], device=dev)
        rep_mask = torch.ones((1, E), dtype=torch.bool, device=dev)
        return self._prefill_more(eng, mcfg, rep_ids, rep_mask, cache,
                                  Lp, Lp + E)

    def _draft_prefill(self, ids: np.ndarray, mask: np.ndarray,
                       req: Request):
        """Chunked prefill of the DRAFT model's batch-1 cache for one
        admission (its logits unused: the draft only proposes from decode
        steps). Replays run the same continuation spans, so the draft's
        clock lands where the target's does."""
        de = self.draft_engine
        dev = de.device
        _, sub = self._prefill(de, torch.from_numpy(ids).to(dev),
                               torch.from_numpy(mask).to(dev))
        if req.replay_tokens:
            _, sub = self._replay(de, self._draft_mcfg, req, ids.shape[1],
                                  sub)
        return sub

    def _admit_prefill(self, req: Request, lane: int, cache,
                       draft_cache) -> int:
        """Exact (chunked when needed) prefill of one prompt on a
        ``[1, Lp]`` batch, spliced into row ``lane`` of ``cache`` (and of
        ``draft_cache`` with speculative decoding); returns the first
        token."""
        eng = self.engine
        ids, mask = self._padded(req)
        Lp = ids.shape[1]
        # the draft's cache is always built here: a hand-off carries only
        # the target's
        if self.draft_engine is not None:
            draft_cache.splice(self._draft_prefill(ids, mask, req), lane)
        if req.kv_handoff is not None:
            first_tok, sub = req.kv_handoff
            cache.splice(sub, lane)
            return int(first_tok)
        dev = eng.device
        ids_t = torch.from_numpy(ids).to(dev)
        mask_t = torch.from_numpy(mask).to(dev)
        if self.prefix_cache is not None:
            logits, sub = self._prefix_prefill(ids, mask, ids_t, mask_t,
                                               req.request_id)
        else:
            logits, sub = self._prefill(eng, ids_t, mask_t)
        if req.replay_tokens:
            # the emitted tokens as continuation passes from Lp: the pad
            # offset and the spans of the uninterrupted run, so the cache
            # (and every later logit) is the one of the run that died
            logits, sub = self._replay(eng, self._mcfg, req, Lp, sub)
        cache.splice(sub, lane)
        return int(eng._next_token(logits, self.temperature > 0)[0])

    def _prefix_prefill(self, ids: np.ndarray, mask: np.ndarray, ids_t,
                        mask_t, request_id):
        """Admission prefill through the shared-prefix cache (JAX
        :726-782).

        The key is the PADDED column prefix (pads as -1): positions advance
        for pad columns too and rotary phases are baked into cached keys, so
        a cached prefix is exact only at the same padded offset. On a hit
        the entry is copied into the engine's batch-1 cache and the prefill
        resumes from its length (``continuation_chunk_spans``: spans that
        never cross a layout block). On a promotion
        (``promotion_target``) the prefix ``[0, c)`` is prefilled, a copy
        of the cache at ``c`` inserted, and the prefill continued to
        ``Lp``. With neither this is the cold ``_chunked_prefill``."""
        eng = self.engine
        pc = self.prefix_cache
        Lp = ids.shape[1]
        cols = tuple(int(t) if m else -1 for t, m in zip(ids[0], mask[0]))
        # limit Lp-1 keeps >= 1 column for the continuation pass, so the
        # last pass always gives the last token's logits
        entry = start = target = None
        if self.leader:
            entry = pc.lookup(cols, limit=Lp - 1, request_id=request_id)
            start = 0 if entry is None else entry.length
            target = pc.promotion_target(cols, limit=Lp - 1, have=start)
        # rank 0's hit and promotion; the other ranks' caches hold the same
        # keys (the same inserts and evictions, in the same order)
        start, target = self.decide((start, target))
        if not self.leader and start:
            entry = pc.follow(cols[:start])
        cache = None
        if entry is not None:
            cache = eng._decoder(1).cache.copy_(entry.cache)
            pc.release(entry)

        logits = None
        if cache is None:
            cold_end = target if target is not None else Lp
            logits, cache = self._prefill(eng, ids_t[:, :cold_end],
                                          mask_t[:, :cold_end])
            start = cold_end
        if target is not None and target > start:
            logits, cache = self._prefill_more(
                eng, self._mcfg, ids_t[:, start:target],
                mask_t[:, start:target], cache, start, target)
            start = target
        if target is not None:
            pc.insert(cols[:target], cache.clone(), request_id=request_id)
        if start < Lp:
            logits, cache = self._prefill_more(
                eng, self._mcfg, ids_t[:, start:], mask_t[:, start:], cache,
                start, Lp)
        return logits, cache

    def kv_cache_stats(self, hbm_override_gib: Optional[float] = None
                       ) -> Dict[str, Any]:
        """KV-cache bytes of the ``[slots]``-lane cache (JAX :784-838).

        ``resident_bytes`` is what the cache holds (int8 keys and values
        plus their f32 scales under ``kv_cache_dtype="int8"``);
        ``unquantized_bytes`` the same geometry with keys and values in the
        compute dtype and no scales. The port keeps one ``valid`` and one
        ``index`` for all layers (flax one per layer), so its bookkeeping
        bytes differ from JAX's; the keys, values and scales are the same.
        With the card's memory (or ``hbm_override_gib``),
        ``lanes_at_hbm_budget`` is how many lanes of this footprint fit."""
        out = dict(self._kv_static())
        hbm, source = hbm_bytes(self.engine.device, hbm_override_gib)
        if hbm:
            out["hbm_bytes"] = int(hbm)
            out["hbm_source"] = source
            per_lane = out["bytes_per_lane"]
            out["lanes_at_hbm_budget"] = (int(hbm // per_lane)
                                          if per_lane else 0)
        return out

    def _kv_static(self) -> Dict[str, Any]:
        """The lanes' cache geometry part of ``kv_cache_stats``, once."""
        if self._kv_stats_static is None:
            cache = self.engine._decoder(self.slots).cache
            compute = torch.finfo(self._mcfg.dtype).bits // 8
            kv = [t for group in (cache.key, cache.value) for t in group]
            scales = [t for group in (cache.key_scale or [],
                                      cache.value_scale or [])
                      for t in group]
            resident = cache.nbytes()
            side = sum(t.numel() * t.element_size() for t in kv + scales)
            unquant = resident - side + sum(t.numel() * compute for t in kv)
            self._kv_stats_static = {
                "kv_cache_dtype": self._mcfg.kv_cache_dtype or "compute",
                "resident_bytes": int(resident),
                "unquantized_bytes": int(unquant),
                "bytes_per_lane": int(resident // self.slots),
                "lanes": self.slots,
                "compression_ratio": (float(unquant) / float(resident)
                                      if resident else 1.0),
            }
        return self._kv_stats_static

    def frontdoor_stats(self) -> Dict[str, Any]:
        """Shed, prefix-cache and health counters for servers."""
        out: Dict[str, Any] = {"shed": self.shed_count,
                               "deadline_shed": self.deadline_shed_count,
                               "pending": len(self._pending),
                               "lanes_active": self._lanes_active,
                               "draining": self._draining}
        if self.prefix_cache is not None:
            out["prefix"] = self.prefix_cache.stats()
        if self.admission_controller is not None and \
                hasattr(self.admission_controller, "stats"):
            out["admission"] = self.admission_controller.stats()
        if self.journal is not None and hasattr(self.journal, "stats"):
            out["journal"] = self.journal.stats()
        if self.health_provider is not None and \
                hasattr(self.health_provider, "states"):
            out["health"] = dict(self.health_provider.states())
        if self.draft_engine is not None:
            out["spec"] = {
                "k": self.spec_k,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": (self.spec_accepted / self.spec_proposed
                                if self.spec_proposed else 0.0)}
        if self._kv_stats_static is not None:
            out["kv_cache"] = self.kv_cache_stats()
        return out

    def _publish_stats(self, stats: ServingStats, lanes) -> None:
        """One ``serve.stats`` per loop iteration: queue depth, lane
        occupancy, shed counters, prefix hit rate, fleet health and the
        lanes' KV bytes."""
        self._lanes_active = sum(1 for ln in lanes if ln is not None)
        payload: Dict[str, Any] = {
            "queue_depth": len(self._pending),
            "lanes_active": self._lanes_active,
            "shed": self.shed_count,
            "deadline_shed": self.deadline_shed_count,
            "decode_steps": stats.decode_steps,
            "draining": self._draining,
        }
        if self.prefix_cache is not None:
            payload["prefix_hit_rate"] = \
                self.prefix_cache.stats().get("hit_rate", 0.0)
        if self.health_provider is not None and \
                hasattr(self.health_provider, "states"):
            payload["health"] = dict(self.health_provider.states())
        if not self.leader:
            return
        kv = self._kv_static()
        payload["kv_resident_bytes"] = kv["resident_bytes"]
        payload["kv_unquantized_bytes"] = kv["unquantized_bytes"]
        publish(KIND_SERVE_STATS, **payload)

    # ------------------------------------------------------------------
    def _recycle(self, lanes, cache, cfg, cols: int) -> None:
        """Empty each free lane of ``cache`` whose clock cannot take
        ``cols`` more columns (its garbage would write out of bounds; a
        streaming ring has no bound)."""
        if cfg.sparse_attention is not None and \
                ring_engaged(cfg) is not None and not cfg.learned_positions:
            return
        full = [ln for ln in range(self.slots) if lanes[ln] is None
                and cache.lengths[ln] + cols > cfg.n_positions]
        if full:
            cache.reset_rows(full)

    def _take(self) -> Optional[tuple]:
        """The next admission, ``(request, t_submit)``, or None when the
        queue is empty; expired requests are shed first. Over a serving
        group rank 0's, the same on every rank (the other ranks drop the
        hand-offs of the requests it shed)."""
        taken, shed = None, []
        while self.leader and self._pending:
            req, t_submit = self._pending.popleft()
            if req.t_deadline is not None and \
                    time.monotonic() > req.t_deadline:
                self._shed_expired(req, t_submit)
                shed.append(req.request_id)
                continue
            taken = (req, t_submit)
            break
        if self._axes is None:
            return taken
        spec = None if taken is None else (
            taken[0].request_id, taken[0].prompt, taken[0].max_new_tokens,
            taken[0].eos_token_id, taken[0].replay_tokens)
        spec, shed = self.decide((spec, shed))
        if self.leader:
            return taken
        for rid in shed:
            self._handoffs.pop(rid, None)
        if spec is None:
            return None
        rid, prompt, n, eos, replay = spec
        return (Request(prompt=prompt, max_new_tokens=n, eos_token_id=eos,
                        request_id=rid, replay_tokens=replay,
                        kv_handoff=self._handoffs.pop(rid, None)),
                time.monotonic())

    def run(self, poll_fn: Optional[Callable[[], None]] = None
            ) -> ServingStats:
        """Serve the queue to completion; returns stats and completions.

        ``poll_fn`` (optional) is called once per loop iteration, between
        decode steps (a replica pumps its control pipe there; over a
        serving group on rank 0 only). While draining (``begin_drain``): no
        new admissions, the lanes decoding finish, and the loop returns
        with the queue intact.
        """
        eng = self.engine
        stats = ServingStats()
        lanes: List[Optional[_Lane]] = [None] * self.slots
        sampled = self.temperature > 0
        self._digest = hashlib.blake2b(digest_size=16)
        if sampled:
            eng._temperature.fill_(self.temperature)
        with torch.inference_mode():
            cache = self._lane_cache(eng)
            decode = eng._decoder(self.slots).decode
            tok = torch.zeros(self.slots, dtype=torch.long,
                              device=eng.device)
            use_spec = self.draft_engine is not None
            draft_cache = snap = draft_snap = draft_decode = None
            if use_spec:
                de = self.draft_engine
                draft_cache = self._lane_cache(de)
                draft_decode = de._decoder(self.slots).decode
                # the snapshots the verify pass rewinds from
                snap, draft_snap = cache.clone(), draft_cache.clone()
            t_run0 = time.monotonic()

            def finish(lane_no: int, lane: _Lane):
                lane.comp.t_done = time.monotonic()
                stats.completions.append(lane.comp)
                lanes[lane_no] = None
                self._publish(KIND_SERVE_EVICT,
                              request_id=lane.req.request_id, lane=lane_no,
                              tokens=lane.emitted,
                              queue_depth=len(self._pending))

            def emit(lane_no: int, lane: _Lane, token: int) -> bool:
                """Record one token; True when the sequence is done."""
                now = time.monotonic()
                lane.comp.tokens.append(token)
                lane.emitted += 1
                if lane.comp.t_first_token == 0.0:
                    lane.comp.t_first_token = now
                    # a replay does not publish it again: the client saw its
                    # first token on the replica that died, and a replay's
                    # sample would bias the admission p95 window
                    if lane.req.replay_tokens is None:
                        self._publish(KIND_SERVE_FIRST_TOKEN,
                                      request_id=lane.req.request_id,
                                      lane=lane_no,
                                      ttft_s=now - lane.comp.t_submit)
                done = (lane.emitted >= lane.req.max_new_tokens
                        or (lane.req.eos_token_id is not None
                            and token == lane.req.eos_token_id))
                if not self.leader:
                    return done
                if self.journal is not None:
                    self.journal.record_token(
                        lane.req.request_id, token, done=done)
                if lane.req.stream_callback is not None:
                    lane.req.stream_callback(lane.req.request_id, token,
                                             done)
                return done

            while True:
                if poll_fn is not None and self.leader:
                    poll_fn()
                active = any(ln is not None for ln in lanes)
                stop = (not active if self._draining
                        else not (self._pending or active))
                stop, self._draining = self._agree(stop)
                if stop:
                    break  # a drain leaves the queue for the journal
                # admissions: fill every free lane from the queue; a request
                # done at admission (max_new_tokens 1, or EOS first) frees
                # its lane for the next at once, and an expired deadline
                # sheds before the prefill. The first empty take ends the
                # round: nothing is submitted before the next token.
                for lane_no in range(self.slots if not self._draining
                                     else 0):
                    while lanes[lane_no] is None:
                        taken = self._take()
                        if taken is None:
                            break
                        req, t_submit = taken
                        replayed = len(req.replay_tokens or ())
                        comp = Completion(
                            request_id=req.request_id,
                            tokens=list(req.replay_tokens or ()),
                            prompt_len=len(req.prompt), t_submit=t_submit)
                        comp.t_admit = time.monotonic()
                        self._publish(KIND_SERVE_ADMIT,
                                      request_id=req.request_id,
                                      lane=lane_no,
                                      prompt_len=len(req.prompt),
                                      replayed=replayed,
                                      queue_wait_s=comp.t_admit - t_submit,
                                      queue_depth=len(self._pending))
                        first_tok = int(self._hash(self._admit_prefill(
                            req, lane_no, cache, draft_cache)))
                        tok[lane_no] = first_tok
                        lane = _Lane(req=req, comp=comp, emitted=replayed)
                        lanes[lane_no] = lane
                        if emit(lane_no, lane, first_tok):
                            finish(lane_no, lane)
                    if lanes[lane_no] is None:
                        break

                self._publish_stats(stats, lanes)
                if not self._lanes_active:
                    continue  # everything admitted finished at token 1

                if use_spec:
                    # the draft proposes k greedy tokens per lane, the
                    # target verifies them in ONE [slots, k+1] pass, and
                    # both caches rewind past each lane's first mismatch.
                    # m_eff = min(m, k-1): no bonus token (accepting all k
                    # would need the draft's k-th proposal in its cache,
                    # which the proposal steps never wrote)
                    k = self.spec_k
                    self._recycle(lanes, cache, self._mcfg, k + 1)
                    self._recycle(lanes, draft_cache, self._draft_mcfg, k)
                    snap.copy_(cache)
                    draft_snap.copy_(draft_cache)
                    props = de._decode_run(draft_decode, draft_cache, tok,
                                           k, False, self.eager)
                    cols = torch.cat([tok[:, None], props], dim=1)
                    g = eng._verify_greedy(cols, cache, eager=self.eager)
                    stats.decode_steps += 1
                    g_np = self._hash(g.cpu().numpy())
                    props_np = self._hash(props.cpu().numpy())
                    matches = props_np == g_np[:, :k]
                    m = np.where(matches.all(axis=1), k,
                                 matches.argmin(axis=1))
                    m_eff = np.minimum(m, k - 1).astype(np.int64)
                    cache.rewind(snap, k - m_eff)
                    draft_cache.rewind(draft_snap, k - 1 - m_eff)
                    live = [ln for ln in range(self.slots)
                            if lanes[ln] is not None]
                    self.spec_proposed += k * len(live)
                    accepted_now = int(sum(int(m_eff[ln]) for ln in live))
                    self.spec_accepted += accepted_now
                    self._publish(KIND_SERVE_SPEC_ACCEPT, k=k,
                                  lanes=len(live), proposed=k * len(live),
                                  accepted=accepted_now,
                                  proposed_total=self.spec_proposed,
                                  accepted_total=self.spec_accepted)
                    for lane_no in live:
                        lane = lanes[lane_no]
                        for j in range(int(m_eff[lane_no]) + 1):
                            if emit(lane_no, lane, int(g_np[lane_no, j])):
                                finish(lane_no, lane)
                                break
                    nxt = g_np[np.arange(self.slots), m_eff]
                    tok.copy_(torch.from_numpy(nxt))
                else:
                    # one fixed-shape decode step for all lanes, free ones
                    # included (rows are independent)
                    self._recycle(lanes, cache, self._mcfg, 1)
                    tok = eng._decode_run(decode, cache, tok, 1, sampled,
                                          self.eager)[:, 0]
                    stats.decode_steps += 1
                    tok_np = self._hash(tok.cpu().numpy())
                    for lane_no in range(self.slots):
                        lane = lanes[lane_no]
                        if lane is None:
                            continue
                        if emit(lane_no, lane, int(tok_np[lane_no])):
                            finish(lane_no, lane)

            stats.wall_s = time.monotonic() - t_run0
        return stats

