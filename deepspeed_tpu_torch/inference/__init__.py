from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  continuation_chunk_spans,
                                                  init_inference,
                                                  prefill_chunk_spans)
from deepspeed_tpu_torch.inference.scheduler import (
    AdmissionRejected, Completion, ContinuousBatchingScheduler,
    QueueFullError, Request, RequestShedError, ServingStats)

__all__ = ["InferenceEngine", "init_inference", "prefill_chunk_spans",
           "continuation_chunk_spans", "ContinuousBatchingScheduler",
           "Request", "Completion", "ServingStats", "AdmissionRejected",
           "QueueFullError", "RequestShedError"]
