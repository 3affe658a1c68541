"""The serving front door (counterpart of ``deepspeed_tpu/serving/``): what
is ported of it. The shared-prefix KV cache (``prefix_cache.py``) and,
from ``inference/scheduler.py``, the continuous-batching scheduler and its
typed rejections. SLO admission control (``admission.py``, which reads the
telemetry bus of ROADMAP A.11), the router, the fleet, disaggregated
serving and ``build_serving`` come later (ROADMAP A.8)."""

from deepspeed_tpu_torch.inference.scheduler import (
    AdmissionRejected, ContinuousBatchingScheduler, DeadlineExceededError,
    DrainingError, QueueFullError, RequestShedError)
from deepspeed_tpu_torch.serving.prefix_cache import (PrefixCache,
                                                      PrefixCacheConfig)

__all__ = ["AdmissionRejected", "ContinuousBatchingScheduler",
           "DeadlineExceededError", "DrainingError", "PrefixCache",
           "PrefixCacheConfig", "QueueFullError", "RequestShedError"]
