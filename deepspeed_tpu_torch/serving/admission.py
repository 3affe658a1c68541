"""SLO-aware admission control for the serving front door (counterpart of
``deepspeed_tpu/serving/admission.py``, the whole module).

The scheduler's queue used to grow without bound: under a burst, every
queued request pays the whole backlog's prefill time, p95 TTFT explodes,
and by the time the queue drains every client has timed out anyway —
the classic overload collapse. The fix every production front door
applies is the same: measure the latency you are actually delivering,
and when it breaches the SLO, shed new arrivals (429) until the backlog
drains, trading a few fast rejections for everyone else's latency.

``SLOAdmissionController`` is a policy object the scheduler consults on
every ``submit()``. It feeds on the telemetry bus rather than private
scheduler state:

* ``serve.first_token`` events supply the rolling TTFT window (the p95
  estimate is computed over the last ``window`` completions);
* ``data.prefetch_starved`` marks host-input backpressure — a starving
  input pipeline means admission prefill is about to slow down, so the
  controller treats it as an early overload signal;
* queue depth arrives with each ``decide()`` call.

Shedding is hysteretic: entered when p95 breaches the SLO with a loaded
queue, left only once p95 recovers below ``recover_frac * slo`` AND the
queue has drained to ``drain_to`` — without the drain condition the
controller would flap, admitting a burst the moment one fast completion
lands.

The bus holds bound-method subscribers weakly, so whoever builds the
controller must keep a strong reference (the scheduler does, via
``admission_controller=``).
"""

import time
from dataclasses import dataclass
from collections import deque
from typing import Any, Dict, Optional, Tuple

from deepspeed_tpu_torch.telemetry.bus import (
    KIND_PREFETCH_STARVED,
    KIND_SERVE_FIRST_TOKEN,
    telemetry_bus,
)


@dataclass
class AdmissionConfig:
    slo_ttft_p95_s: float = 2.0     # the latency promise being held
    window: int = 64                # TTFT samples in the rolling window
    min_samples: int = 8            # below this, p95 is too noisy to act
    recover_frac: float = 0.8       # leave shedding at p95 < frac * slo
    drain_to: Optional[int] = None  # ... AND queue <= this (default: slots)
    starvation_grace_s: float = 2.0  # how long a prefetch-starved signal
                                     # counts as live backpressure
    sample_max_age_s: Optional[float] = 30.0  # TTFT samples older than
    # this are evidence of a past era, not the present: without aging,
    # the first arrivals after an idle period would be judged (and shed)
    # on breach-era p95 evidence that no longer describes the replica.
    # None disables aging (count-bounded window only).

    def __post_init__(self):
        if self.slo_ttft_p95_s <= 0:
            raise ValueError("slo_ttft_p95_s must be positive")
        if not 0 < self.recover_frac <= 1:
            raise ValueError("recover_frac must be in (0, 1]")
        if self.min_samples < 1 or self.window < self.min_samples:
            raise ValueError("need window >= min_samples >= 1")
        if self.sample_max_age_s is not None and self.sample_max_age_s <= 0:
            raise ValueError("sample_max_age_s must be positive (or None)")


class SLOAdmissionController:
    """Sheds load to hold a p95 TTFT SLO; see module docstring."""

    def __init__(self, config: Optional[AdmissionConfig] = None, bus=None,
                 clock=time.monotonic):
        self.config = config or AdmissionConfig()
        self._clock = clock
        self._ttfts: deque = deque(maxlen=self.config.window)
        self._shedding = False
        self._last_starved: Optional[float] = None
        self.shed_decisions = 0
        self.admit_decisions = 0
        self._bus = bus if bus is not None else telemetry_bus
        self._bus.subscribe(self.on_event)

    # -- telemetry intake ---------------------------------------------
    def on_event(self, ev: Dict[str, Any]) -> None:
        kind = ev.get("kind")
        if kind == KIND_SERVE_FIRST_TOKEN and "ttft_s" in ev:
            # samples carry their arrival time so an idle gap ages the
            # whole window out instead of freezing breach-era evidence
            self._ttfts.append((self._clock(), float(ev["ttft_s"])))
        elif kind == KIND_PREFETCH_STARVED:
            self._last_starved = self._clock()

    def _prune_stale(self) -> None:
        max_age = self.config.sample_max_age_s
        if max_age is None:
            return
        horizon = self._clock() - max_age
        while self._ttfts and self._ttfts[0][0] < horizon:
            self._ttfts.popleft()

    def p95_ttft(self) -> Optional[float]:
        self._prune_stale()
        if len(self._ttfts) < self.config.min_samples:
            return None
        xs = sorted(v for _, v in self._ttfts)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    def _input_starved(self) -> bool:
        return (self._last_starved is not None and
                self._clock() - self._last_starved
                < self.config.starvation_grace_s)

    # -- the decision -------------------------------------------------
    def decide(self, queue_depth: int, slots: int) -> Tuple[bool, str]:
        """(admit, reason) for one arriving request."""
        cfg = self.config
        drain_to = cfg.drain_to if cfg.drain_to is not None else slots
        p95 = self.p95_ttft()
        if self._shedding:
            recovered = p95 is None or p95 < cfg.recover_frac * \
                cfg.slo_ttft_p95_s
            if recovered and queue_depth <= drain_to and \
                    not self._input_starved():
                self._shedding = False
            else:
                self.shed_decisions += 1
                return False, (
                    f"draining: p95 ttft {p95 if p95 is not None else 0:.3f}s"
                    f" vs slo {cfg.slo_ttft_p95_s:.3f}s, "
                    f"queue {queue_depth}")
        # a breach only matters when the queue is the cause: with fewer
        # requests than decode lanes, shedding would just waste capacity
        loaded = queue_depth >= max(1, slots)
        if loaded and p95 is not None and p95 > cfg.slo_ttft_p95_s:
            self._shedding = True
            self.shed_decisions += 1
            return False, (f"p95 ttft {p95:.3f}s over slo "
                           f"{cfg.slo_ttft_p95_s:.3f}s at depth "
                           f"{queue_depth}")
        if loaded and self._input_starved():
            self._shedding = True
            self.shed_decisions += 1
            return False, f"input pipeline starved at depth {queue_depth}"
        self.admit_decisions += 1
        return True, "ok"

    # -- introspection ------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        p95 = self.p95_ttft()
        return {
            "shedding": self._shedding,
            "p95_ttft_s": p95,
            "ttft_samples": len(self._ttfts),
            "shed_decisions": self.shed_decisions,
            "admit_decisions": self.admit_decisions,
            "slo_ttft_p95_s": self.config.slo_ttft_p95_s,
        }

    def close(self) -> None:
        self._bus.unsubscribe(self.on_event)
