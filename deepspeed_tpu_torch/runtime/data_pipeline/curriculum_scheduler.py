"""Curriculum learning scheduler (counterpart of
``deepspeed_tpu/runtime/data_pipeline/curriculum_scheduler.py``, kept as
its own copy; reference ``runtime/data_pipeline/curriculum_scheduler.py:8``).

Maps global step -> difficulty (the sequence length). Schedules:
``fixed_linear``, ``fixed_root``, ``fixed_discrete``, ``custom``. The
engine truncates each batch to the current difficulty
(``truncate_batch_to_difficulty``) and, with the data pipeline's
``curriculum_pack``, packs to it. Each distinct difficulty is a new batch
shape, and so one more captured CUDA graph per step function (two warm-up
steps, then a capture): quantize with ``difficulty_step``.
"""

import math
from typing import Any, Callable, Dict, Optional


class CurriculumScheduler:
    def __init__(self, config):
        """``config`` is a CurriculumConfig or a raw dict with the
        reference's keys."""
        if isinstance(config, dict):
            get = config.get
        else:
            get = lambda k, d=None: getattr(config, k, d)  # noqa: E731
        self.curriculum_type = get("curriculum_type", "seqlen")
        self.min_difficulty = int(get("min_difficulty", 1))
        self.max_difficulty = int(get("max_difficulty", 1024))
        self.schedule_type = get("schedule_type", "fixed_linear")
        self.schedule_config: Dict[str, Any] = dict(
            get("schedule_config", {}) or {})
        self.custom_get_difficulty: Optional[Callable[[int], int]] = None
        self.current_difficulty = self.min_difficulty

        if self.schedule_type in ("fixed_linear", "fixed_root"):
            if "total_curriculum_step" not in self.schedule_config:
                raise ValueError(
                    f"{self.schedule_type} schedule needs "
                    f"total_curriculum_step in schedule_config")
            if int(self.schedule_config.get("difficulty_step", 1)) < 8:
                from deepspeed_tpu_torch.utils.logging import logger

                logger.warning(
                    "curriculum difficulty_step < 8: every distinct "
                    "difficulty value is a new batch shape, and each shape "
                    "is captured as one more CUDA graph (after two "
                    "uncaptured warm-up steps); set "
                    "schedule_config.difficulty_step to a multiple of 8 "
                    "to bound the captures")
        if self.schedule_type == "fixed_discrete":
            need = {"difficulty", "max_step"}
            if not need.issubset(self.schedule_config):
                raise ValueError(
                    "fixed_discrete schedule needs difficulty and max_step "
                    "lists")
            d = self.schedule_config["difficulty"]
            s = self.schedule_config["max_step"]
            if len(s) != len(d) - 1:
                raise ValueError(
                    "max_step must have one fewer entry than difficulty")

    def set_custom_get_difficulty(self, fn: Callable[[int], int]):
        self.custom_get_difficulty = fn

    def _quantize(self, difficulty: float) -> int:
        step = int(self.schedule_config.get("difficulty_step", 1))
        d = int(difficulty) // step * step
        return max(min(d, self.max_difficulty), self.min_difficulty)

    def get_difficulty(self, global_steps: int) -> int:
        sc = self.schedule_config
        if self.schedule_type == "custom":
            if self.custom_get_difficulty is None:
                raise ValueError(
                    "custom schedule requires set_custom_get_difficulty")
            return self.custom_get_difficulty(global_steps)
        if self.schedule_type == "fixed_discrete":
            levels = sc["difficulty"]
            bounds = sc["max_step"]
            for level, bound in zip(levels, bounds):
                if global_steps <= bound:
                    return int(level)
            return int(levels[-1])
        total = int(sc["total_curriculum_step"])
        frac = min(global_steps / max(total, 1), 1.0)
        if self.schedule_type == "fixed_root":
            frac = frac ** (1.0 / float(sc.get("root_degree", 2)))
        elif self.schedule_type != "fixed_linear":
            raise ValueError(
                f"unknown curriculum schedule {self.schedule_type!r}")
        span = self.max_difficulty - self.min_difficulty
        return self._quantize(self.min_difficulty + span * frac)

    def update_difficulty(self, global_steps: int) -> int:
        self.current_difficulty = self.get_difficulty(global_steps)
        return self.current_difficulty

    def get_current_difficulty(self) -> int:
        return self.current_difficulty

    def state_dict(self) -> Dict[str, Any]:
        return {"current_difficulty": self.current_difficulty}

    def load_state_dict(self, sd: Dict[str, Any]):
        self.current_difficulty = sd["current_difficulty"]


def truncate_batch_to_difficulty(batch, seqlen: int):
    """Truncate every [B, T, ...] sequence array or tensor in a batch dict
    to the scheduled seqlen difficulty (reference engine.py:1629; one
    captured graph per distinct value)."""
    return {
        k: (v[:, :seqlen]
            if getattr(v, "ndim", 0) >= 2 and v.shape[1] > seqlen
            else v)
        for k, v in batch.items()
    }
