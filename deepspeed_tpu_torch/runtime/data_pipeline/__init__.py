"""Curriculum learning (counterpart of
``deepspeed_tpu/runtime/data_pipeline/``)."""

from deepspeed_tpu_torch.runtime.data_pipeline.curriculum_scheduler import (  # noqa: F401
    CurriculumScheduler,
    truncate_batch_to_difficulty,
)
