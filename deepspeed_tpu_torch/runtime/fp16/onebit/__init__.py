"""The 1-bit optimizers (counterpart of
``deepspeed_tpu/runtime/fp16/onebit/__init__.py``)."""

from deepspeed_tpu_torch.runtime.fp16.onebit.adam import (  # noqa: F401
    OnebitAdam,
    compressed_allreduce,
    padded_length,
)
from deepspeed_tpu_torch.runtime.fp16.onebit.lamb import (  # noqa: F401
    OnebitLamb,
    ZeroOneAdam,
)
