"""1-bit LAMB and 0/1 Adam (counterpart of
``deepspeed_tpu/runtime/fp16/onebit/lamb.py``), on 1-bit Adam's
compressed momentum exchange (``adam.py``):

* ``OnebitLamb``: 1-bit Adam's warm-up and compressed phases, then LAMB's
  trust ratio ``|w| / |update|`` per JAX leaf, clipped to [0.01, 10], at
  the step.
* ``ZeroOneAdam``: the momentum exchanged compressed from the first step;
  the variance refreshed exactly (the mean gradient, one all-reduce) at
  step 1 and every ``var_update_period`` steps. The phase (refresh or
  not) is a host value, one captured graph each.
"""

import torch

from deepspeed_tpu_torch.runtime.fp16.onebit.adam import (
    COMPRESSED, OnebitAdam, _f32_pow_complement)

REFRESH = "refresh"


class OnebitLamb(OnebitAdam):
    """JAX ``onebit_lamb`` (:32): the 1-bit Adam direction at lr 1 (cast to
    the parameter's dtype), plus decoupled weight decay, scaled by the
    trust ratio of its JAX leaf (a leaf stacking the layers under
    ``scan_layers`` takes one ratio for all of them), then by -lr."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, warmup_steps=100, axis="dp",
                 axis_size=None, names=None, layout=None,
                 min_trust: float = 0.01, max_trust: float = 10.0):
        super().__init__(params, lr, b1, b2, eps, weight_decay, warmup_steps,
                         axis, axis_size, names, layout)
        self.min_trust, self.max_trust = min_trust, max_trust

    def _new_params(self, members):
        """One leaf's parameters, scaled by the leaf's trust ratio."""
        neg_lr = self.scalars[0]
        updates = []
        for i in members:
            p = self.params[i]
            upd = -((-1.0 * self._direction(i)).to(p.dtype))
            if self.weight_decay > 0:
                upd = upd + self._wd[p.dtype] * p
            updates.append(upd)
        params = [self.params[i] for i in members]
        wn, un = (torch.stack(torch._foreach_norm(xs, 2, dtype=torch.float32))
                  .square().sum().sqrt() for xs in (params, updates))
        trust = torch.where(
            (wn > 0) & (un > 0),
            torch.clamp(wn / torch.clamp(un, min=1e-12), self.min_trust,
                        self.max_trust), 1.0)
        return [p + (neg_lr * trust * upd).to(p.dtype)
                for p, upd in zip(params, updates)]


class ZeroOneAdam(OnebitAdam):
    """JAX ``zero_one_adam`` (:78): compressed momentum every step; the
    variance refreshed from the exact mean gradient when the count is 1 or
    a multiple of ``var_update_period``, its bias correction counting the
    refreshes (``1 + count // period``)."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, var_update_period: int = 16, axis="dp",
                 axis_size=None, names=None, layout=None):
        super().__init__(params, lr, b1, b2, eps, weight_decay, 1, axis,
                         axis_size, names, layout)
        self.var_update_period = int(var_update_period)

    def phase(self) -> tuple:
        count = self.count + 1
        refresh = count % self.var_update_period == 0 or count == 1
        return (REFRESH,) if refresh else (COMPRESSED,)

    def _biases(self, count: int):
        return (_f32_pow_complement(self.b1, count),
                _f32_pow_complement(self.b2,
                                    1 + count // self.var_update_period))

    def _leaf_moments(self, li: int, g: torch.Tensor, phase: str):
        m, v = (self.layout.leaf(buf, li)
                for buf in (self.exp_avg, self.exp_avg_sq))
        m_new, errors = self._exchange(li, self.b1 * m + (1 - self.b1) * g)
        if phase == REFRESH:
            g_avg = self._mean(g, "zero_one_adam_variance")
            v = self.b2 * v + (1 - self.b2) * g_avg * g_avg
        return m_new, v, errors
