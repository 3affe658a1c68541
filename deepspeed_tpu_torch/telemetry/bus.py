"""Rank-tagged in-process telemetry bus (counterpart of
``deepspeed_tpu/telemetry/bus.py``, the whole module).

Every subsystem that makes a *discrete decision* (the ring KV cache
declining a demand, the prefetcher starving, the serving scheduler admitting
or evicting a lane, the fleet migrating a request) publishes a structured
event here. Subscribers (admission control, tests) see them in publish
order.

Design constraints, in priority order:

1. **Telemetry never breaks serving or training.** ``publish`` swallows
   subscriber exceptions (warning once per subscriber) and never raises.
2. **Cheap enough for hot paths.** One lock, one dict build, one call per
   subscriber: microseconds. No torch import and no device sync: payload
   values are host-side Python scalars (publishers own that contract).
3. **Supervisor-importable.** stdlib only.

The process-global ``telemetry_bus`` is the instance everything uses;
``TelemetryBus`` exists separately for test isolation. The training engine
sets its rank from the process group (``comm.get_rank()``).
"""

import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional

# Event kinds published by the repo's subsystems (one flat namespace,
# dotted by subsystem). Not an enum: third-party publishers may add their
# own kinds and the bus does not gatekeep.
KIND_SENTINEL_SKIP = "sentinel.skip"
KIND_SENTINEL_ROLLBACK = "sentinel.rollback"
KIND_SENTINEL_DIVERGED = "sentinel.diverged"
KIND_WATCHDOG_FIRE = "sentinel.watchdog_fire"
KIND_CKPT_COMMIT = "checkpoint.commit"
KIND_CKPT_FALLBACK = "checkpoint.fallback"
KIND_RING_DECLINE = "ring.decline"
KIND_BUCKET_PLAN = "comm.bucket_plan"
KIND_COMM_HIERARCHY = "comm.hierarchy_plan"
KIND_PREFETCH_STARVED = "data.prefetch_starved"
KIND_SERVE_ADMIT = "serve.admit"
KIND_SERVE_EVICT = "serve.evict"
KIND_SERVE_FIRST_TOKEN = "serve.first_token"
KIND_SERVE_PREFIX_HIT = "serve.prefix_hit"
KIND_SERVE_PREFIX_MISS = "serve.prefix_miss"
KIND_SERVE_PREFIX_EVICT = "serve.prefix_evict"
KIND_SERVE_SHED = "serve.shed"
KIND_SERVE_DEADLINE_SHED = "serve.deadline_shed"
KIND_SERVE_REPLICA_DOWN = "serve.replica_down"
KIND_SERVE_REPLICA_UP = "serve.replica_up"
KIND_SERVE_FAILOVER = "serve.failover"
KIND_SERVE_DRAIN = "serve.drain"
KIND_SERVE_STATS = "serve.stats"
KIND_SERVE_KV_TRANSFER = "serve.kv_transfer"
KIND_SERVE_SPEC_ACCEPT = "serve.spec_accept"
KIND_SHUTDOWN = "shutdown.graceful"
KIND_ELASTIC_RESHARD = "elastic.reshard"
# cluster health plane (runtime/health.py): peer liveness over the
# out-of-band heartbeat mesh, step-time straggler detection, step-skew
# desync, and SDC parameter-digest mismatches
KIND_HEALTH_PEER_DOWN = "health.peer_down"
KIND_HEALTH_PEER_UP = "health.peer_up"
KIND_HEALTH_STRAGGLER = "health.straggler"
KIND_HEALTH_DESYNC = "health.desync"
KIND_HEALTH_SDC = "health.sdc"
KIND_HEALTH_ABORT = "health.abort"


def _default_rank() -> int:
    # rank guess for processes that never call set_rank (the training
    # engine sets the process group's rank at init); JAX's variables
    for var in ("DS_TPU_RANK", "JAX_PROCESS_INDEX", "RANK"):
        v = os.environ.get(var)
        if v and v.isdigit():
            return int(v)
    return 0


class TelemetryBus:
    """Thread-safe pub/sub fan-out of structured telemetry events."""

    def __init__(self, rank: Optional[int] = None):
        self._rank = _default_rank() if rank is None else int(rank)
        self._lock = threading.Lock()
        self._subscribers: List[Callable[[Dict[str, Any]], None]] = []
        self._broken: set = set()
        self._counts: Dict[str, int] = {}

    @property
    def rank(self) -> int:
        return self._rank

    def set_rank(self, rank: int) -> None:
        self._rank = int(rank)

    @staticmethod
    def _ref(fn):
        """Bound methods are held weakly: the global bus outlives every
        engine, and a strong ref to ``recorder.on_event`` would pin each
        dead engine's recorder (and its monitor's open csv handles)
        forever. Plain functions/closures stay strong — a weak ref to a
        lambda would die instantly."""
        if hasattr(fn, "__self__") and hasattr(fn, "__func__"):
            # builtin bound methods (list.append) have __self__ but no
            # __func__ and WeakMethod rejects them — those stay strong
            return weakref.WeakMethod(fn)
        return fn

    @staticmethod
    def _deref(ref):
        return ref() if isinstance(ref, weakref.WeakMethod) else ref

    def subscribe(self, fn: Callable[[Dict[str, Any]], None]):
        """Register ``fn(event_dict)``; returns ``fn`` for unsubscribe."""
        ref = self._ref(fn)
        with self._lock:
            if ref not in self._subscribers:
                self._subscribers.append(ref)
        return fn

    def unsubscribe(self, fn) -> None:
        ref = self._ref(fn)
        with self._lock:
            if ref in self._subscribers:
                self._subscribers.remove(ref)
            self._broken.discard(id(fn))

    def publish(self, kind: str, step: Optional[int] = None,
                severity: str = "info", **payload) -> Dict[str, Any]:
        """Publish one event; returns the event dict (tests inspect it)."""
        ev: Dict[str, Any] = {
            "ts": time.time(),
            "kind": str(kind),
            "rank": self._rank,
            "severity": severity,
        }
        if step is not None:
            ev["step"] = int(step)
        if payload:
            ev.update(payload)
        with self._lock:
            self._counts[ev["kind"]] = self._counts.get(ev["kind"], 0) + 1
            subscribers = []
            dead = []
            for ref in self._subscribers:
                fn = self._deref(ref)
                if fn is None:
                    dead.append(ref)  # its recorder was GC'd
                else:
                    subscribers.append(fn)
            for ref in dead:
                self._subscribers.remove(ref)
        for fn in subscribers:
            try:
                fn(ev)
            except Exception as e:
                if id(fn) not in self._broken:
                    self._broken.add(id(fn))
                    # local import: the bus stays stdlib-only to import
                    from deepspeed_tpu_torch.utils.logging import logger

                    logger.warning(
                        "telemetry subscriber %r raised %s: %s — muting "
                        "further warnings from it", fn, type(e).__name__, e)
        return ev

    def counts(self) -> Dict[str, int]:
        """Cumulative publish count per kind (for dumps and tests)."""
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        """Drop subscribers and counts (test isolation only)."""
        with self._lock:
            self._subscribers.clear()
            self._broken.clear()
            self._counts.clear()


# The process-global bus. Module-level publishers (ring declines, bucket
# plans, prefetch starvation) and the engine's flight recorder all share
# this instance; its rank tag is set once by the engine.
telemetry_bus = TelemetryBus()


def publish(kind: str, step: Optional[int] = None, severity: str = "info",
            **payload) -> Dict[str, Any]:
    """Publish on the process-global bus (the one-liner publishers use)."""
    return telemetry_bus.publish(kind, step=step, severity=severity,
                                 **payload)
