"""ZeRO public API surface (counterpart of
``deepspeed_tpu/runtime/zero/__init__.py``).

The reference exports ``zero.Init`` and ``GatheredParameters``. The
port's engine partitions at stages 1-2 the optimizer state (and the
gradient accumulators), never the parameters (stage 3 is ROADMAP A.3's
second half), so every rank holds whole parameters and "gathering" them is
a host copy.
"""

import contextlib

from deepspeed_tpu_torch.runtime.checkpoint_engine import to_host
from deepspeed_tpu_torch.runtime.zero.sharding import ZeroShardingRules  # noqa: F401


class Init(contextlib.AbstractContextManager):
    """reference ``zero.Init``: construct a model with its parameters
    partitioned from the start. The port's models build on the meta
    device and the engine materialises them, so this context is a
    documented no-op kept for API parity; its arguments are recorded."""

    def __init__(self, module=None, data_parallel_group=None,
                 mem_efficient_linear=True, remote_device=None,
                 pin_memory=False, config_dict_or_path=None, config=None,
                 enabled=True, dtype=None, mpu=None):
        self.enabled = enabled
        self.remote_device = remote_device
        self.config = config_dict_or_path or config

    def __exit__(self, *exc):
        return False


class GatheredParameters(contextlib.AbstractContextManager):
    """reference ``GatheredParameters``: inside the context, ``.params``
    holds whole host copies of the given parameters."""

    def __init__(self, params, modifier_rank=None, fwd_module=None,
                 enabled=True):
        self._src = params
        self.enabled = enabled
        self.params = None

    def __enter__(self):
        self.params = gather_params(self._src) if self.enabled else self._src
        return self

    def __exit__(self, *exc):
        return False


def gather_params(params):
    """Whole host copies of a parameter tree (tensors in dicts, lists and
    tuples)."""
    return to_host(params)
