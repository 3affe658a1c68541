"""The MoE layer (counterpart of ``deepspeed_tpu/moe/layer.py``: ``MoE``
:49 and ``expert_axis`` :114).

The gate is an f32 ``[M, E]`` dense layer on f32 input (a parameter that
stays f32 when the model's ``param_dtype`` is bf16, as JAX's
``param_dtype=jnp.float32`` keeps it), the gating is ``topk_gating`` at the
training capacity factor in training mode and ``eval_capacity_factor``
otherwise, the experts are one ``StackedExperts``, and the layer returns
``(y, l_aux, exp_counts)``; the model adds ``aux_coef * l_aux`` to its
loss.

Tokens reach the experts by index (``dispatch_by_index`` /
``combine_by_index``), which computes what the JAX layer's dense one-hot
products compute (``dispatch_tokens`` / ``combine_tokens``, the plain
version the tests hold it against). The gating noise comes in with the call (``noise``: one ``[T, E]`` tensor per
kind that ``noise_kinds`` names, stacked), never from a generator inside
the layer. Expert parallelism (the ``ep`` mesh axis, ``moe_param_spec``
and the all-to-all) is ROADMAP A.9: here every expert lives on the card.
"""

import types
from typing import Optional, Tuple

import torch
import torch.nn as nn

from deepspeed_tpu_torch.models.transformer_lm import Dense
from deepspeed_tpu_torch.moe.experts import StackedExperts
from deepspeed_tpu_torch.moe.sharded_moe import (combine_by_index,
                                                 dispatch_by_index,
                                                 topk_gating)

# the gate's Dense: f32 parameters, f32 compute
_GATE = types.SimpleNamespace(param_dtype=torch.float32, dtype=torch.float32)


def gating_noise_kinds(k: int, noisy_gate_policy: Optional[str],
                       use_rts: bool) -> Tuple[str, ...]:
    """The draws a training-mode gating takes, in the order they stack in
    ``MoE``'s ``noise`` (JAX's split order): top-1 takes gumbel noise under
    RSample, then the RTS uniforms; top-2 the second expert's gumbel
    noise."""
    if k == 2:
        return ("gumbel",)
    return ((("gumbel",) if noisy_gate_policy == "RSample" else ())
            + (("uniform",) if use_rts else ()))


def draw_gating_noise(out: torch.Tensor, kinds: Tuple[str, ...],
                      generator: torch.Generator) -> torch.Tensor:
    """Fill ``out`` ([..., len(kinds), T, E] f32) in place from
    ``generator``: uniforms on [0, 1), and for a gumbel kind ``-log(-log
    u)`` of uniforms on [tiny, 1) (``jax.random.gumbel``'s formula)."""
    out.uniform_(generator=generator)
    tiny = torch.finfo(torch.float32).tiny
    for i, kind in enumerate(kinds):
        if kind == "gumbel":
            g = out.select(-3, i)
            g.clamp_(min=tiny).log_().neg_().log_().neg_()
    return out


class MoE(nn.Module):
    """Drop-in FFN replacement: ``[..., M] -> ([..., M], l_aux,
    exp_counts)``."""

    def __init__(self, d_model, d_hidden, num_experts=1, k=1,
                 capacity_factor=1.0, eval_capacity_factor=1.0,
                 min_capacity=4, noisy_gate_policy=None, drop_tokens=True,
                 use_rts=True, dtype=torch.bfloat16,
                 param_dtype=torch.float32, gated_experts=False,
                 expert_activation=None):
        super().__init__()
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens, self.use_rts = drop_tokens, use_rts
        self.gate = Dense(d_model, num_experts, _GATE, bias=False)
        # materialize_gpt leaves this f32 under a bf16 param_dtype
        self.gate.keep_param_dtype = True
        self.experts = StackedExperts(
            num_experts, d_model, d_hidden, dtype=dtype,
            param_dtype=param_dtype, activation=expert_activation,
            gated=gated_experts, use_bias=not gated_experts)

    def noise_kinds(self) -> Tuple[str, ...]:
        return gating_noise_kinds(self.k, self.noisy_gate_policy,
                                  self.use_rts)

    def forward(self, x, noise: Optional[torch.Tensor] = None):
        """``noise``: ``[len(noise_kinds()), T, E]`` draws for this call's
        T tokens, or None (no noise, JAX's ``rng=None``)."""
        shape = x.shape
        tokens = x.reshape(-1, shape[-1])
        logits = self.gate(tokens.float())
        draws = {}
        if noise is not None:
            draws = dict(zip(self.noise_kinds(), noise.unbind(0)))
        gating = dict(gumbel=draws.get("gumbel"),
                      noisy_gate_policy=self.noisy_gate_policy,
                      drop_tokens=self.drop_tokens, use_rts=self.use_rts)
        if self.k == 1:
            gating["uniform"] = draws.get("uniform")
        gout = topk_gating(
            logits, self.k,
            capacity_factor=(self.capacity_factor if self.training
                             else self.eval_capacity_factor),
            min_capacity=self.min_capacity, **gating)
        dispatched = dispatch_by_index(gout.routing, tokens)
        y = combine_by_index(gout.routing, self.experts(dispatched),
                             dtype=x.dtype)
        return y.reshape(shape), gout.l_aux, gout.exp_counts


def expert_axis(path: str, ndim: int) -> Optional[int]:
    """The expert axis of a ``StackedExperts`` leaf (JAX :114): third from
    last for ``wi``/``wg``/``wo``, second from last for ``bi``/``bo``, or
    None for any other leaf or a shape too small to carry one. ``path``
    may name the leaf with dots (the port's names) or slashes (JAX's)."""
    path = path.replace(".", "/")
    if "experts/" not in path:
        return None
    if path.endswith(("experts/wi", "experts/wg", "experts/wo")):
        ax = ndim - 3
    elif path.endswith(("experts/bi", "experts/bo")):
        ax = ndim - 2
    else:
        return None
    return ax if ax >= 0 else None
