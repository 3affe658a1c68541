"""Stacked expert FFNs (counterpart of ``deepspeed_tpu/moe/experts.py``:
``StackedExperts`` :18).

One parameter tensor per weight with the expert axis first (``wi``/``wg``
``[E, M, H]``, ``wo`` ``[E, H, M]``, ``bi`` ``[E, H]``, ``bo`` ``[E, M]``),
the JAX layout, so a checkpoint splits along axis 0 and the expert-parallel
layout (ROADMAP A.9) addresses the same axis. The per-expert loop is one
batched product over the expert axis in the compute dtype.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


def _gelu_tanh(x):
    # flax's nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


class StackedExperts(nn.Module):
    """``[E, C, M] -> [E, C, M]``: each expert's two-layer FFN, or with
    ``gated`` its SwiGLU FFN ``wo @ (act(wg x) * (wi x))`` (Mixtral),
    biases (``bi``, ``bo``) when ``use_bias``. ``activation`` defaults to
    flax's ``nn.gelu`` (tanh), or SiLU when gated, as the JAX ``MoE``
    picks it. Parameters are made on the current default device (the GPT
    builds them on the meta device)."""

    def __init__(self, num_experts, d_model, d_hidden, dtype=torch.bfloat16,
                 param_dtype=torch.float32, activation=None, gated=False,
                 use_bias=True):
        super().__init__()
        E, M, H = num_experts, d_model, d_hidden
        self.num_experts, self.d_model, self.d_hidden = E, M, H
        self.compute_dtype = dtype
        self.gated = gated
        self.activation = activation or (F.silu if gated else _gelu_tanh)

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=param_dtype))

        self.wi = param(E, M, H)
        self.wo = param(E, H, M)
        self.wg = param(E, M, H) if gated else None
        self.bi = param(E, H) if use_bias else None
        self.bo = param(E, M) if use_bias else None

    def fan_in(self, name: str) -> int:
        """flax ``lecun_normal``'s fan-in of a 3-D weight: the input axis
        times the expert axis (``_compute_fans`` counts every axis but the
        last two as receptive field)."""
        return self.num_experts * (self.d_hidden if name == "wo"
                                   else self.d_model)

    def forward(self, x):
        dt = self.compute_dtype
        x = x.to(dt)
        h = torch.bmm(x, self.wi.to(dt))
        if self.bi is not None:
            h = h + self.bi[:, None, :].to(dt)
        if self.gated:
            g = torch.bmm(x, self.wg.to(dt))
            h = self.activation(g) * h
        else:
            h = self.activation(h)
        y = torch.bmm(h, self.wo.to(dt))
        if self.bo is not None:
            y = y + self.bo[:, None, :].to(dt)
        return y
