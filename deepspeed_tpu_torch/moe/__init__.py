"""Mixture of experts (counterpart of ``deepspeed_tpu/moe/``), at one card:
the expert-parallel layout (``ep``) is ROADMAP A.9."""

from deepspeed_tpu_torch.moe.experts import StackedExperts  # noqa: F401
from deepspeed_tpu_torch.moe.layer import (MoE, draw_gating_noise,  # noqa: F401
                                           expert_axis, gating_noise_kinds)
from deepspeed_tpu_torch.moe.sharded_moe import (  # noqa: F401
    GatingOutput, Routing, combine_by_index, combine_tokens,
    dispatch_by_index, dispatch_tokens, static_capacity, top1_gating,
    top2_gating, topk_gating)
from deepspeed_tpu_torch.moe.utils import (is_moe_param_path,  # noqa: F401
                                           split_moe_params)
