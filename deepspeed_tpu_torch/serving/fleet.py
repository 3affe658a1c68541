"""Fleet fault tolerance: replica health, in-flight journaling, exact
failover replay, and graceful drain (counterpart of
``deepspeed_tpu/serving/fleet.py``, the whole module).

Serving across replicas multiplies the chance that *some* replica is dead
at any moment. Four pieces compose into the front door's control loop:

* :class:`FleetHealth` -- a heartbeat-driven per-replica state machine
  (``healthy -> suspect -> down -> recovering -> healthy``, the
  :class:`SilenceSchedule` of ``utils/health_state.py``). Any message from
  a replica is a heartbeat; silence degrades the state on a configured
  schedule, and a pipe EOF (the unambiguous signal) jumps straight to
  ``down``. ``serve.replica_down`` / ``serve.replica_up`` fire on the
  down/up edges only. Routing consults ``live()``: a ``down`` replica
  receives nothing, and a recovered one gets its hash-affine homes back
  (the home mapping is a pure hash; only the live mask changes).

* :class:`RequestJournal` -- the per-request flight record: prompt, every
  token *delivered to the client*, assigned replica, deadline. This is
  what makes failover exact: greedy decode is a pure function of
  (weights, prompt so far), so a survivor that re-prefills ``prompt +
  emitted`` (the scheduler's ``replay_tokens``, continuation passes at the
  original pad offset) continues as the dead replica would have. Tokens a
  dying replica generated but never put on the wire are not in the
  journal, and that is the right cut: the client never saw them, and the
  replay regenerates them.

* :class:`FleetCoordinator` -- routes with the live mask and
  journal-derived queue depths, journals every placement and token, and
  on a replica death turns that replica's in-flight entries into replay
  assignments on survivors: exactly one ``serve.failover`` event per
  migrated request.

* :class:`GracefulDrain` -- SIGTERM posture for one serving process:
  admission closes (``DrainingError``), in-flight lanes finish, queued
  requests are handed off as journal replay specs, and a flight
  recorder's signal-time dump, when one is given (duck-typed: the recorder
  is ROADMAP A.11), is retracted on clean completion.

Everything here is policy: no torch and no process spawning.
``chip_smoke.py``'s ``frontdoor`` phase wires it to replica processes over
pipes and kills one mid-decode.
"""

import signal as signal_module
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from deepspeed_tpu_torch.serving.router import ROLE_DECODE, ROLE_PREFILL
from deepspeed_tpu_torch.telemetry.bus import (
    KIND_SERVE_DRAIN,
    KIND_SERVE_FAILOVER,
    KIND_SERVE_KV_TRANSFER,
    KIND_SERVE_REPLICA_DOWN,
    KIND_SERVE_REPLICA_UP,
    telemetry_bus,
)
# the silence-schedule state machine lives in utils/health_state.py;
# re-exported as in JAX (``from ...serving.fleet import HEALTHY, ...``)
from deepspeed_tpu_torch.utils.health_state import (  # noqa: F401
    DOWN,
    HEALTHY,
    RECOVERING,
    SUSPECT,
    HealthConfig,
    SilenceSchedule,
)


class ReplicaDead(RuntimeError):
    """A replica's pipe hit EOF / its process died (raised by transport
    helpers; carries the replica index)."""

    def __init__(self, replica: int, message: str = ""):
        super().__init__(message or f"replica {replica} is dead")
        self.replica = int(replica)


class FleetHealth:
    """Heartbeat-driven replica health; see module docstring.

    ``heartbeat(i)`` on every message from replica ``i``; ``sweep()``
    before every routing decision (time drives the degradations);
    ``mark_down(i)`` when the transport says so (EOF beats any timer).
    Thread-safe: the demo pumps replica pipes from one thread, but
    signal handlers and tests poke it from others.

    A thin serving skin over :class:`SilenceSchedule`: the state machine
    lives in ``utils/health_state.py``; this class owns only the
    edge-triggered ``serve.replica_down`` / ``serve.replica_up``
    telemetry (published from the schedule's transition hook, i.e. at
    exactly the point the pre-extraction ``_set`` published).
    """

    def __init__(self, n_replicas: int, config: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic, bus=None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self.n_replicas = int(n_replicas)
        self._bus = bus if bus is not None else telemetry_bus
        self._schedule = SilenceSchedule(
            self.n_replicas, config=config, clock=clock,
            on_transition=self._on_transition)

    @property
    def config(self) -> HealthConfig:
        return self._schedule.config

    @property
    def transitions(self) -> List[Tuple[float, int, str, str]]:
        # (ts, replica, from, to) — bounded by the number of real
        # transitions, which is tiny; tests and the demo read it
        return self._schedule.transitions

    def _on_transition(self, i: int, frm: str, to: str, reason: str,
                       probes: int) -> None:
        """Publishes only on the down/up edges."""
        if to == DOWN:
            self._bus.publish(KIND_SERVE_REPLICA_DOWN, severity="warning",
                              replica=i, previous=frm, reason=reason)
        elif to == HEALTHY and frm in (RECOVERING, DOWN):
            self._bus.publish(KIND_SERVE_REPLICA_UP, replica=i,
                              probes=probes)

    def heartbeat(self, i: int) -> str:
        """Replica ``i`` showed a sign of life; returns its new state."""
        return self._schedule.heartbeat(i)

    def sweep(self) -> None:
        """Apply the silence schedule to every replica."""
        self._schedule.sweep()

    def mark_down(self, i: int, reason: str = "reported") -> None:
        """Unambiguous death (pipe EOF, waitpid): skip the timers."""
        self._schedule.mark_down(i, reason)

    def state(self, i: int) -> str:
        return self._schedule.state(i)

    def states(self) -> Dict[int, str]:
        return self._schedule.states()

    def live(self) -> List[bool]:
        """The routing mask: everything except ``down`` is routable —
        ``suspect`` keeps its traffic (it may just be slow) and
        ``recovering`` gets its homes back (re-affinity)."""
        return self._schedule.live()

    def n_live(self) -> int:
        return self._schedule.n_live()


# ---------------------------------------------------------------------
@dataclass
class JournalEntry:
    """One request's flight record. ``emitted`` holds every token that
    reached the client, in order — the replay prefix."""
    request_id: Any
    prompt: List[int]
    max_new_tokens: int
    emitted: List[int] = field(default_factory=list)
    replica: Optional[int] = None
    deadline: Optional[float] = None  # absolute, caller's clock domain
    done: bool = False
    shed: bool = False
    failovers: int = 0
    t_submit: float = 0.0
    t_first_token: Optional[float] = None

    @property
    def remaining_tokens(self) -> int:
        return self.max_new_tokens - len(self.emitted)


class RequestJournal:
    """Per-request prompt + delivered-token record; see module docstring.

    ``retain_done=False`` drops finished entries immediately (the
    long-lived-server setting); the default keeps them so benches and
    tests can audit full completions.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 retain_done: bool = True):
        self._clock = clock
        self._retain_done = bool(retain_done)
        self._lock = threading.Lock()
        self._entries: Dict[Any, JournalEntry] = {}
        self.completed = 0
        self.shed_count = 0
        self.failover_count = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def record_submit(self, request_id, prompt: Sequence[int],
                      max_new_tokens: int, replica: Optional[int] = None,
                      deadline: Optional[float] = None,
                      emitted: Sequence[int] = ()) -> JournalEntry:
        """A replayed request re-enters with its ``emitted`` prefix."""
        e = JournalEntry(
            request_id=request_id, prompt=[int(t) for t in prompt],
            max_new_tokens=int(max_new_tokens),
            emitted=[int(t) for t in emitted], replica=replica,
            deadline=deadline, t_submit=self._clock())
        with self._lock:
            if request_id in self._entries:
                raise ValueError(f"request {request_id!r} already journaled")
            self._entries[request_id] = e
        return e

    def record_token(self, request_id, token: int,
                     done: bool = False) -> None:
        """Append one DELIVERED token; unknown ids are tolerated (a
        completion racing a failover must not crash the pump)."""
        with self._lock:
            e = self._entries.get(request_id)
            if e is None or e.done:
                return
            e.emitted.append(int(token))
            if e.t_first_token is None:
                e.t_first_token = self._clock()
            if done:
                self._finish(e)

    def record_done(self, request_id) -> None:
        with self._lock:
            e = self._entries.get(request_id)
            if e is not None and not e.done:
                self._finish(e)

    def record_shed(self, request_id) -> None:
        """The request was intentionally dropped (deadline, drain)."""
        with self._lock:
            e = self._entries.get(request_id)
            if e is None or e.done:
                return
            e.shed = True
            self.shed_count += 1
            self._finish(e, completed=False)

    def _finish(self, e: JournalEntry, completed: bool = True) -> None:
        e.done = True
        if completed:
            self.completed += 1
        if not self._retain_done:
            self._entries.pop(e.request_id, None)

    def reassign(self, request_id, replica: int) -> JournalEntry:
        with self._lock:
            e = self._entries[request_id]
            e.replica = int(replica)
            e.failovers += 1
            self.failover_count += 1
            return e

    def entry(self, request_id) -> Optional[JournalEntry]:
        with self._lock:
            return self._entries.get(request_id)

    def inflight(self, replica: Optional[int] = None) -> List[JournalEntry]:
        """Open entries, oldest first (insertion order), optionally for
        one replica — the failover work list."""
        with self._lock:
            return [e for e in self._entries.values()
                    if not e.done and
                    (replica is None or e.replica == replica)]

    def depths(self, n_replicas: int) -> List[int]:
        """Journal-derived queue depth per replica — the router's load
        signal without a cross-process round trip."""
        out = [0] * int(n_replicas)
        with self._lock:
            for e in self._entries.values():
                if not e.done and e.replica is not None and \
                        0 <= e.replica < len(out):
                    out[e.replica] += 1
        return out

    def replay_spec(self, request_id) -> Dict[str, Any]:
        """The exact-replay recipe for one in-flight request: re-prefill
        ``prompt`` (+ ``replay_tokens`` via continuation spans) and keep
        decoding under the ORIGINAL token budget."""
        with self._lock:
            e = self._entries[request_id]
            if e.done:
                raise ValueError(
                    f"request {request_id!r} already finished — "
                    "nothing to replay")
            if e.remaining_tokens < 1:
                raise ValueError(
                    f"request {request_id!r} has no token budget left")
            return {"prompt": list(e.prompt),
                    "replay_tokens": list(e.emitted),
                    "max_new_tokens": e.max_new_tokens,
                    "deadline": e.deadline}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            inflight = sum(1 for e in self._entries.values() if not e.done)
        return {"inflight": inflight, "completed": self.completed,
                "shed": self.shed_count, "failovers": self.failover_count}


# ---------------------------------------------------------------------
class FleetCoordinator:
    """Health-aware routing + journaling + failover for one front door.

    The owner pumps replica transports and calls: ``place`` per arriving
    request, ``on_token`` per delivered token (heartbeating separately
    via ``health.heartbeat``), and ``replica_dead`` on EOF — which
    returns the migrated work as ``(request_id, new_replica, spec)``
    triples, publishing exactly one ``serve.failover`` each.
    """

    def __init__(self, router, health: Optional[FleetHealth] = None,
                 journal: Optional[RequestJournal] = None,
                 clock: Callable[[], float] = time.monotonic, bus=None,
                 roles: Optional[Sequence[str]] = None):
        self.router = router
        self._clock = clock
        self._bus = bus if bus is not None else telemetry_bus
        self.health = health if health is not None else FleetHealth(
            router.n_replicas, clock=clock, bus=self._bus)
        self.journal = journal if journal is not None else \
            RequestJournal(clock=clock)
        # role-aware placement (disaggregated serving): the fleet keeps
        # GLOBAL replica indices — health, journal depths, and telemetry
        # all speak them — but routes each kind of traffic over a
        # pool-local sub-router so prefill replicas never take decode
        # lanes (and vice versa). The sub-routers share the main
        # router's align/spill_slack so affinity behaves identically.
        self.roles: Optional[List[str]] = None
        self._decode_pool = list(range(router.n_replicas))
        self._prefill_pool: List[int] = []
        self._decode_router = router
        self._prefill_router = None
        self.kv_transfers = 0
        self.kv_bytes = 0
        if roles is not None:
            roles = [str(r) for r in roles]
            if len(roles) != router.n_replicas:
                raise ValueError(
                    f"got {len(roles)} roles for "
                    f"{router.n_replicas} replicas")
            bad = set(roles) - {ROLE_PREFILL, ROLE_DECODE}
            if bad:
                raise ValueError(
                    f"unknown replica roles {sorted(bad)}; choose from "
                    f"('{ROLE_PREFILL}', '{ROLE_DECODE}')")
            self.roles = roles
            self._decode_pool = [i for i, r in enumerate(roles)
                                 if r == ROLE_DECODE]
            self._prefill_pool = [i for i, r in enumerate(roles)
                                  if r == ROLE_PREFILL]
            if not self._decode_pool:
                raise ValueError(
                    "a fleet needs at least one decode replica")
            mk = type(router)
            self._decode_router = mk(len(self._decode_pool),
                                     align=router.align,
                                     spill_slack=router.spill_slack)
            if self._prefill_pool:
                self._prefill_router = mk(len(self._prefill_pool),
                                          align=router.align,
                                          spill_slack=router.spill_slack)

    def _pool_route(self, pool: List[int], sub_router, prompt
                    ) -> Tuple[int, str]:
        """Route over one role pool; returns the GLOBAL replica index.
        Depth and liveness vectors are global — sliced down to the pool
        so a busy prefill replica never biases decode spill decisions."""
        self.health.sweep()
        depths = self.journal.depths(self.router.n_replicas)
        live = self.health.live()
        local, how = sub_router.route(
            prompt, [depths[i] for i in pool],
            live=[live[i] for i in pool])
        return pool[local], how

    def place(self, request_id, prompt: Sequence[int], max_new_tokens: int,
              deadline_s: Optional[float] = None) -> Tuple[int, str]:
        """Route one request over live DECODE replicas and journal it;
        returns ``(replica, 'affine'|'spill'|'failover')``."""
        replica, how = self._pool_route(self._decode_pool,
                                        self._decode_router, prompt)
        deadline = None if deadline_s is None else \
            self._clock() + float(deadline_s)
        self.journal.record_submit(request_id, prompt, max_new_tokens,
                                   replica=replica, deadline=deadline)
        return replica, how

    def place_prefill(self, prompt: Sequence[int]) -> Tuple[int, str]:
        """Route one PREFILL job over the live prefill replicas (hash
        affinity keeps a tenant's shared prefix warm on its prefill
        home, same as decode affinity). Not journaled — the flight
        record belongs to the decode placement; the prefill replica's
        output is a KV hand-off, not client tokens."""
        if not self._prefill_pool:
            raise ValueError(
                "this fleet has no prefill replicas (construct "
                "FleetCoordinator with roles=[...ROLE_PREFILL...])")
        return self._pool_route(self._prefill_pool,
                                self._prefill_router, prompt)

    def record_kv_transfer(self, request_id, from_replica: int,
                           to_replica: int, nbytes: int,
                           transfer_s: Optional[float] = None) -> None:
        """Account one prefill->decode KV hand-off and publish
        ``serve.kv_transfer`` — the wire-cost ledger of disaggregation
        (int8 KV shrinks exactly this number)."""
        self.kv_transfers += 1
        self.kv_bytes += int(nbytes)
        payload: Dict[str, Any] = dict(
            request_id=request_id, from_replica=int(from_replica),
            to_replica=int(to_replica), bytes=int(nbytes),
            transfers_total=self.kv_transfers,
            bytes_total=self.kv_bytes)
        if transfer_s is not None:
            payload["transfer_s"] = float(transfer_s)
        self._bus.publish(KIND_SERVE_KV_TRANSFER, **payload)

    def on_token(self, request_id, token: int, done: bool = False) -> None:
        self.journal.record_token(request_id, token, done=done)

    def replica_dead(self, replica: int, reason: str = "eof"
                     ) -> List[Tuple[Any, int, Dict[str, Any]]]:
        """Mark ``replica`` down and migrate its in-flight requests.

        Each migrated request is re-routed over the survivors (its home
        hash is unchanged, so the router's failover branch picks the
        shallowest live replica), reassigned in the journal, and
        announced with ONE ``serve.failover`` event. Raises
        ``NoLiveReplicasError`` when nobody is left to take the work.
        """
        self.health.mark_down(replica, reason=reason)
        moved: List[Tuple[Any, int, Dict[str, Any]]] = []
        for e in self.journal.inflight(replica=replica):
            spec = self.journal.replay_spec(e.request_id)
            target, _how = self._pool_route(self._decode_pool,
                                            self._decode_router, e.prompt)
            self.journal.reassign(e.request_id, target)
            self._bus.publish(
                KIND_SERVE_FAILOVER, severity="warning",
                request_id=e.request_id, from_replica=replica,
                to_replica=target, emitted=len(spec["replay_tokens"]),
                remaining=spec["max_new_tokens"] -
                len(spec["replay_tokens"]), reason=reason)
            moved.append((e.request_id, target, spec))
        return moved

    def stats(self) -> Dict[str, Any]:
        out = {"health": {str(k): v for k, v in
                          self.health.states().items()},
               "journal": self.journal.stats(),
               "router": self._decode_router.stats()}
        if self.roles is not None:
            out["roles"] = list(self.roles)
            out["kv_transfer"] = {"transfers": self.kv_transfers,
                                  "bytes": self.kv_bytes}
            if self._prefill_router is not None:
                out["prefill_router"] = self._prefill_router.stats()
        return out


# ---------------------------------------------------------------------
class GracefulDrain:
    """SIGTERM -> close admission, finish lanes, hand off the queue.

    ``install()`` chains a signal handler that calls the scheduler's
    ``begin_drain()`` — from that instant ``submit()`` raises
    ``DrainingError`` and ``run()`` stops admitting, finishing only the
    lanes already decoding. After ``run()`` returns, ``complete()``
    turns the still-queued requests into journal replay specs (the
    hand-off artifact for whoever restarts the replica), retracts the
    flight recorder's signal-time blackbox (a drained exit is a clean
    exit, not a crash), and publishes the terminal ``serve.drain``.
    """

    def __init__(self, scheduler, recorder=None, bus=None):
        self.scheduler = scheduler
        self.recorder = recorder
        self._bus = bus if bus is not None else telemetry_bus
        self.drained = False

    def install(self, signals=("SIGTERM",)) -> Callable[[], None]:
        """Chain drain triggers onto ``signals`` (main thread only — the
        ``signal`` module's rule, same guard as the crash handlers).
        Returns an ``uninstall()`` restoring what was replaced."""
        restorers: List[Callable[[], None]] = []
        if threading.current_thread() is not threading.main_thread():
            return lambda: None
        for name in signals:
            signum = getattr(signal_module, str(name), None)
            if signum is None:
                continue
            prev = signal_module.getsignal(signum)

            def _handler(sig, frame, _name=str(name), _prev=prev):
                self.scheduler.begin_drain(reason=f"signal:{_name}")
                if callable(_prev):
                    _prev(sig, frame)

            signal_module.signal(signum, _handler)

            def _restore(snum=signum, h=_handler, p=prev):
                if signal_module.getsignal(snum) is h:
                    try:
                        signal_module.signal(snum, p)
                    except (ValueError, TypeError):
                        pass

            restorers.append(_restore)

        def uninstall():
            for r in restorers:
                r()

        return uninstall

    def complete(self) -> List[Dict[str, Any]]:
        """Call after ``run()`` returns under a drain; returns the
        replay specs for every request that never reached a lane."""
        sched = self.scheduler
        handoff: List[Dict[str, Any]] = []
        journal = getattr(sched, "journal", None)
        if journal is not None:
            for e in journal.inflight():
                try:
                    handoff.append(journal.replay_spec(e.request_id))
                except ValueError:
                    continue
        if self.recorder is not None:
            # a crash handler may have dumped a blackbox at signal time
            # (nobody knew then whether the drain would finish); it did,
            # so that dump is stale evidence: retract it
            self.recorder.retract_dump()
        self._bus.publish(KIND_SERVE_DRAIN, phase="complete",
                          handed_off=len(handoff),
                          clean=not getattr(sched, "_lanes_active", 0))
        self.drained = True
        return handoff
