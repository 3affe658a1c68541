"""The throughput timer (counterpart of ``deepspeed_tpu/utils/timer.py``'s
``ThroughputTimer``). It fences, waiting for the card with
``torch.cuda.synchronize()``, before it reads the clock (CUDA launches
return before the work is done); without a card the fence is a no-op."""

import time

import torch

from deepspeed_tpu_torch.utils.logging import log_dist


def fence():
    """Wait until the card has finished all queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
