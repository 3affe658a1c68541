from deepspeed_tpu_torch.inference.engine import (InferenceEngine,
                                                  init_inference,
                                                  prefill_chunk_spans)

__all__ = ["InferenceEngine", "init_inference", "prefill_chunk_spans"]
