"""Wall-clock and throughput timers (counterpart of
``deepspeed_tpu/utils/timer.py``: ``SynchronizedWallClockTimer`` :107 and
``ThroughputTimer``). They fence, waiting for the card with
``torch.cuda.synchronize()``, before they read the clock (CUDA launches
return before the work is done); without a card the fence is a no-op. The
engine starts and stops them on the host, around its step calls, never
inside a step function that a CUDA graph captures."""

import time
from collections import OrderedDict

import torch

from deepspeed_tpu_torch.utils.logging import log_dist


def fence():
    """Wait until the card has finished all queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer:
    def __init__(self, name: str):
        self.name_ = name
        self.started_ = False
        self.elapsed_ = 0.0
        self.start_time = 0.0
        self.count = 0

    def start(self, sync: bool = True):
        assert not self.started_, f"timer {self.name_} has already been started"
        if sync:
            fence()
        self.start_time = time.time()
        self.started_ = True

    def stop(self, reset: bool = False, sync: bool = True):
        assert self.started_, f"timer {self.name_} is not started"
        if sync:
            fence()
        elapsed = time.time() - self.start_time
        self.elapsed_ = elapsed if reset else self.elapsed_ + elapsed
        self.started_ = False
        self.count += 1

    def reset(self):
        self.started_ = False
        self.elapsed_ = 0.0
        self.count = 0

    def elapsed(self, reset: bool = True):
        started = self.started_
        if started:
            self.stop()
        elapsed = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return elapsed

    def mean(self):
        return (self.elapsed_ / self.count) if self.count else 0.0


class SynchronizedWallClockTimer:
    """Named timers; ``log()`` prints a one-line breakdown in ms, as the
    ``wall_clock_breakdown`` output of the JAX engine does."""

    def __init__(self):
        self.timers = OrderedDict()

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    def log(self, names=None, normalizer: float = 1.0, reset: bool = True,
            ranks=None):
        assert normalizer > 0.0
        names = names if names is not None else list(self.timers)
        parts = []
        for name in names:
            if name in self.timers:
                elapsed = (self.timers[name].elapsed(reset=reset) * 1000.0
                           / normalizer)
                parts.append(f"{name}: {elapsed:.2f}")
        if parts:
            log_dist("time (ms) | " + " | ".join(parts), ranks=ranks)

    def get_mean(self, names, normalizer: float = 1.0):
        assert normalizer > 0.0
        return {name: self.timers[name].mean() * 1000.0 / normalizer
                for name in names if name in self.timers}


class ThroughputTimer:
    """Samples per second over fenced intervals: steps in between are not
    fenced (a fence every step would serialize host and card), so the
    rate is reported only at ``steps_per_output`` boundaries, from the wall
    time between two fences."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50, logging_fn=None):
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.logging = logging_fn or (lambda msg: log_dist(msg, ranks=[0]))
        self.micro_step_count = 0
        self.global_step_count = 0
        self._fence_time = None
        self._fence_step = 0
        self._fenced_time = 0.0
        self._fenced_steps = 0

    def _reseed(self):
        fence()
        self._fence_time = time.time()
        self._fence_step = self.global_step_count

    def stop(self, global_step: bool = False):
        self.micro_step_count += 1
        if not global_step:
            return
        self.global_step_count += 1
        if self.global_step_count < self.start_step:
            return
        if self._fence_time is None:
            # the end of the last warm-up step anchors the measured region
            self._reseed()
            return
        if self.global_step_count % self.steps_per_output == 0:
            prev_time, prev_step = self._fence_time, self._fence_step
            self._reseed()
            span = self._fence_time - prev_time
            steps = self.global_step_count - prev_step
            self._fenced_time += span
            self._fenced_steps += steps
            curr = self.batch_size * steps / span if span > 0 else 0.0
            self.logging(
                f"global_step={self.global_step_count}, "
                f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.3f}, "
                f"CurrSamplesPerSec={curr:.3f}")

    def avg_samples_per_sec(self):
        if self._fenced_time > 0:
            return self.batch_size * self._fenced_steps / self._fenced_time
        return 0.0
