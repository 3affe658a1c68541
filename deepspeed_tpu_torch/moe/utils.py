"""MoE parameter utilities (counterpart of ``deepspeed_tpu/moe/utils.py``):
the expert / non-expert split is a predicate on the parameter's name."""

from typing import Iterable, List, Tuple

import torch


def is_moe_param_path(path: str) -> bool:
    """True for an expert parameter (sharded over ``ep`` in the JAX
    package, not reduced over it); dotted or slashed names."""
    path = path.replace(".", "/")
    return "experts/" in path or path.endswith("/experts")


def split_moe_params(named_params: Iterable[Tuple[str, torch.Tensor]]
                     ) -> Tuple[List[Tuple[str, torch.Tensor]],
                                List[Tuple[str, torch.Tensor]]]:
    """``(expert, non_expert)`` lists of ``(name, parameter)`` (the JAX
    function splits a tree into two trees with None at the other
    leaves)."""
    expert, dense = [], []
    for name, p in named_params:
        (expert if is_moe_param_path(name) else dense).append((name, p))
    return expert, dense
