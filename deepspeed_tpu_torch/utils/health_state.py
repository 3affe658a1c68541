"""Shared silence-schedule health state machine (counterpart of
``deepspeed_tpu/utils/health_state.py``, the whole module).

``serving/fleet.py``'s ``FleetHealth`` tracks replica liveness with this
one state machine: ``healthy -> suspect -> down -> recovering -> healthy``,
where any sign of life is a heartbeat that moves the state left and silence
degrades it right on a configured schedule. A transport-level EOF (the
unambiguous death signal) skips the timers via ``mark_down``.

The schedule is policy-free about *what* a member is and *what happens* on
a transition: callers pass ``on_transition(member, frm, to, reason,
probes)`` and publish their own telemetry there (``FleetHealth`` keeps its
edge-only ``serve.replica_down``/``serve.replica_up`` events). The callback
runs under the schedule's lock, so observers see transitions in order.

stdlib only, like everything a supervisor imports.
"""

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

# Member health states (the full cycle: healthy -> suspect -> down ->
# recovering -> healthy; heartbeats move left, silence moves right)
HEALTHY = "healthy"
SUSPECT = "suspect"
DOWN = "down"
RECOVERING = "recovering"

# on_transition(member, from_state, to_state, reason, probes)
TransitionHook = Callable[[int, str, str, str, int], None]


@dataclass
class HealthConfig:
    suspect_after_s: float = 2.0   # silence before healthy -> suspect
    down_after_s: float = 6.0      # silence before (any live) -> down
    recover_probes: int = 2        # heartbeats to go recovering -> healthy

    def __post_init__(self):
        if not 0 < self.suspect_after_s < self.down_after_s:
            raise ValueError(
                "need 0 < suspect_after_s < down_after_s, got "
                f"{self.suspect_after_s} / {self.down_after_s}")
        if self.recover_probes < 1:
            raise ValueError(
                f"recover_probes must be >= 1, got {self.recover_probes}")


class SilenceSchedule:
    """Heartbeat-driven liveness for ``n`` members; see module docstring.

    ``heartbeat(i)`` on every sign of life from member ``i``; ``sweep()``
    whenever time should drive the degradations; ``mark_down(i)`` when
    the transport says so (EOF beats any timer). Thread-safe: callers
    pump heartbeats from receiver threads while supervisors and tests
    poke the schedule from others.
    """

    def __init__(self, n: int, config: Optional[HealthConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[TransitionHook] = None):
        if n < 1:
            raise ValueError(f"member count must be >= 1, got {n}")
        self.n = int(n)
        self.config = config or HealthConfig()
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        now = self._clock()
        self._state = [HEALTHY] * self.n
        self._last_beat = [now] * self.n
        self._probes = [0] * self.n
        # (ts, member, from, to) — bounded by the number of real
        # transitions, which is tiny; tests and demos read it
        self.transitions: List[Tuple[float, int, str, str]] = []

    def _set(self, i: int, to: str, reason: str) -> None:
        """Caller holds the lock; fires the hook on every real edge."""
        frm = self._state[i]
        if frm == to:
            return
        self._state[i] = to
        self.transitions.append((self._clock(), i, frm, to))
        if self._on_transition is not None:
            self._on_transition(i, frm, to, reason, self._probes[i])

    def heartbeat(self, i: int) -> str:
        """Member ``i`` showed a sign of life; returns its new state."""
        with self._lock:
            self._last_beat[i] = self._clock()
            st = self._state[i]
            if st == DOWN:
                self._probes[i] = 1
                if self.config.recover_probes <= 1:
                    self._set(i, HEALTHY, "recovered")
                else:
                    self._set(i, RECOVERING, "heartbeat")
            elif st == RECOVERING:
                self._probes[i] += 1
                if self._probes[i] >= self.config.recover_probes:
                    self._set(i, HEALTHY, "recovered")
            elif st == SUSPECT:
                self._set(i, HEALTHY, "heartbeat")
            return self._state[i]

    def sweep(self) -> None:
        """Apply the silence schedule to every member."""
        with self._lock:
            now = self._clock()
            for i in range(self.n):
                st = self._state[i]
                if st == DOWN:
                    continue
                silence = now - self._last_beat[i]
                if silence >= self.config.down_after_s:
                    self._probes[i] = 0
                    self._set(i, DOWN, f"silent {silence:.1f}s")
                elif st == HEALTHY and \
                        silence >= self.config.suspect_after_s:
                    self._set(i, SUSPECT, "silence")

    def mark_down(self, i: int, reason: str = "reported") -> None:
        """Unambiguous death (pipe EOF, waitpid): skip the timers."""
        with self._lock:
            self._probes[i] = 0
            self._set(i, DOWN, reason)

    def state(self, i: int) -> str:
        with self._lock:
            return self._state[i]

    def states(self) -> Dict[int, str]:
        with self._lock:
            return {i: s for i, s in enumerate(self._state)}

    def live(self) -> List[bool]:
        """The routing/membership mask: everything except ``down`` is
        live — ``suspect`` may just be slow and ``recovering`` is on its
        way back."""
        with self._lock:
            return [s != DOWN for s in self._state]

    def n_live(self) -> int:
        return sum(self.live())

    def silence(self, i: int) -> float:
        """Seconds since member ``i`` last showed life (for telemetry)."""
        with self._lock:
            return self._clock() - self._last_beat[i]
