"""ZeRO public API surface (counterpart of
``deepspeed_tpu/runtime/zero/__init__.py``).

The reference exports ``zero.Init`` and ``GatheredParameters``. At stages
0-2 every rank holds whole parameters, so gathering one is a host copy; at
stage 3 (``runtime/zero/stage3.py``) a partitioned parameter is an empty
placeholder on the module, and gathering it is an all-gather of its
unit's shards.
"""

import contextlib

from deepspeed_tpu_torch.runtime.checkpoint_engine import _map_tensors, to_host
from deepspeed_tpu_torch.runtime.zero.sharding import ZeroShardingRules  # noqa: F401


class Init(contextlib.AbstractContextManager):
    """reference ``zero.Init``: construct a model with its parameters
    partitioned from the start. The port's models build on the meta
    device, and the engine materialises them and, at stage 3, partitions
    them unit by unit at construction (each unit's buffer is made whole
    once, broadcast, and cut to the rank's shard), so this context is a
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
    holds whole host copies of the given parameters. Read-only, as in the
    JAX package: ``modifier_rank`` is accepted and ignored, and a change to
    ``.params`` does not reach the model."""

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
    tuples). A stage-3 placeholder is all-gathered from its unit's shards
    first: a collective, so every rank calls it with the same tree."""
    def whole(t):
        owner = getattr(t, "ds_zero", None)
        return t if owner is None else owner.gather_param(t)

    return to_host(_map_tensors(whole, params))
