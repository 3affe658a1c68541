from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  continuation_chunk_spans,
                                                  init_inference,
                                                  prefill_chunk_spans)

__all__ = ["InferenceEngine", "continuation_chunk_spans", "init_inference",
           "prefill_chunk_spans"]
