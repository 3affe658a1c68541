"""Learning-rate schedules (counterpart of
``deepspeed_tpu/runtime/lr_schedules.py``): LRRangeTest, OneCycle, WarmupLR
and WarmupDecayLR as ``step -> lr`` functions on host floats (the JAX
package evaluates the same formulas in f32 inside its compiled step), and
the stateful ``LRScheduler`` with the reference's ``step()/get_lr()/
get_last_lr()/state_dict()`` surface."""

import math
from typing import Any, Callable, Dict, List, Optional

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR]


def _clip(x, lo, hi):
    return min(max(x, lo), hi)


def lr_range_test_fn(lr_range_test_min_lr: float = 1e-3,
                     lr_range_test_step_size: int = 2000,
                     lr_range_test_step_rate: float = 1.0,
                     lr_range_test_staircase: bool = False,
                     **_) -> Callable:
    """Continuous or staircase LR ramp."""

    def fn(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate)

    return fn


def one_cycle_fn(cycle_min_lr: float, cycle_max_lr: float,
                 cycle_first_step_size: int = 2000,
                 cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0,
                 cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0,
                 decay_lr_rate: float = 0.0,
                 **_) -> Callable:
    """Triangular cycle, then an optional decay."""
    second = (cycle_second_step_size if cycle_second_step_size is not None
              else cycle_first_step_size)
    total_cycle = cycle_first_step_size + second

    def fn(step):
        if step <= cycle_first_step_size:
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * (
                step / cycle_first_step_size)
        if step <= total_cycle:
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * (
                (step - cycle_first_step_size) / second)
        if decay_step_size > 0:
            decay_steps = (step - total_cycle) / decay_step_size
            return cycle_min_lr / (1.0 + decay_steps * decay_lr_rate)
        return cycle_min_lr

    return fn


def warmup_lr_fn(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000, warmup_type: str = "log",
                 **_) -> Callable:
    """Log or linear warmup, then constant."""
    log_denom = math.log(max(warmup_num_steps, 2))

    def fn(step):
        if step >= warmup_num_steps:
            return warmup_max_lr
        if warmup_type == "log":
            gamma = math.log(step + 1.0) / log_denom
        else:
            gamma = step / max(warmup_num_steps, 1)
        gamma = _clip(gamma, 0.0, 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * gamma

    return fn


def warmup_decay_lr_fn(total_num_steps: int, warmup_min_lr: float = 0.0,
                       warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                       warmup_type: str = "log", **_) -> Callable:
    """Warmup, then linear decay to 0 at ``total_num_steps``."""
    warm = warmup_lr_fn(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                        warmup_type)

    def fn(step):
        if step < warmup_num_steps:
            return warm(step)
        frac = (total_num_steps - step) / max(1, total_num_steps - warmup_num_steps)
        return warmup_max_lr * _clip(frac, 0.0, 1.0)

    return fn


_FACTORIES = {
    LR_RANGE_TEST: lr_range_test_fn,
    ONE_CYCLE: one_cycle_fn,
    WARMUP_LR: warmup_lr_fn,
    WARMUP_DECAY_LR: warmup_decay_lr_fn,
}


def schedule_fn_from_config(sched_type: str, params: Dict[str, Any]) -> Callable:
    if sched_type not in _FACTORIES:
        raise ValueError(
            f"Unknown scheduler type {sched_type!r}; valid: {VALID_LR_SCHEDULES}")
    return _FACTORIES[sched_type](**params)


class LRScheduler:
    """The reference schedulers' object surface over a schedule function."""

    def __init__(self, schedule_fn: Callable, last_batch_iteration: int = -1):
        self.schedule_fn = schedule_fn
        self.last_batch_iteration = last_batch_iteration
        self._last_lr: List[float] = self.get_lr()

    def get_lr(self) -> List[float]:
        return [float(self.schedule_fn(max(0, self.last_batch_iteration)))]

    def get_last_lr(self) -> List[float]:
        return list(self._last_lr)

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = self.get_lr()

    def state_dict(self) -> Dict[str, Any]:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict[str, Any]):
        self.last_batch_iteration = sd["last_batch_iteration"]
        self._last_lr = self.get_lr()


class WarmupLR(LRScheduler):
    def __init__(self, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type="log",
                 last_batch_iteration=-1, **_):
        super().__init__(
            warmup_lr_fn(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type), last_batch_iteration)


class WarmupDecayLR(LRScheduler):
    def __init__(self, total_num_steps, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type="log",
                 last_batch_iteration=-1, **_):
        super().__init__(
            warmup_decay_lr_fn(total_num_steps, warmup_min_lr, warmup_max_lr,
                               warmup_num_steps, warmup_type),
            last_batch_iteration)


class OneCycle(LRScheduler):
    def __init__(self, cycle_min_lr, cycle_max_lr, **kwargs):
        last = kwargs.pop("last_batch_iteration", -1)
        super().__init__(one_cycle_fn(cycle_min_lr, cycle_max_lr, **kwargs), last)


class LRRangeTest(LRScheduler):
    def __init__(self, **kwargs):
        last = kwargs.pop("last_batch_iteration", -1)
        super().__init__(lr_range_test_fn(**kwargs), last)


def build_lr_scheduler(sched_type: str, params: Dict[str, Any]) -> LRScheduler:
    return LRScheduler(schedule_fn_from_config(sched_type, params))
