"""Optimizer construction from the DeepSpeed config (counterpart of
``deepspeed_tpu/runtime/optimizer.py:34-134``).

The same rules as the JAX package: the Adam family with ``adam_w_mode``
(the default) and ``tpu.use_pallas_optimizer`` takes the fused kernel
(``ops/cuda/fused_adam.FusedAdamW``, B4); otherwise ``AdamW``, written out
in PyTorch with ``optax.adamw``'s arithmetic (moments in the parameter
dtype, the same bias correction and decoupled decay; ``torch.optim``'s
update order rounds differently), or with ``adam_w_mode=False`` Adam with
coupled L2 decay. LAMB, Adagrad, SGD and the 1-bit family are not ported.

Unlike an optax transformation, a PyTorch optimizer owns its state, so
``build_optimizer`` takes the parameters. Every optimizer here has
``step(grads)``, with one gradient per parameter in the parameter's dtype,
and advances its own ``count`` only when it steps; and the same step in
three parts, ``prepare()`` (the host writes the step's scalars into device
buffers), ``apply(grads, skip)`` (device work only, which a CUDA graph can
hold) and ``commit(updated)`` (the count).
"""

from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from deepspeed_tpu_torch.ops.cuda.fused_adam import FusedAdamW
from deepspeed_tpu_torch.runtime import constants as C


def _normalize_betas(params: Dict[str, Any]):
    betas = params.get("betas", (0.9, 0.999))
    return float(betas[0]), float(betas[1])


class AdamW:
    """Adam with ``optax.adamw``'s arithmetic, or with coupled L2 decay
    (``optax.chain(add_decayed_weights, adam)``) when ``adam_w_mode`` is
    False. ``mu``/``nu`` live in the parameter dtype; every operation runs
    in that dtype, in optax's order. ``lr`` is a float or a
    ``count -> lr`` schedule read at the count before the increment.

    The constants are device scalars in each parameter dtype, made once;
    ``prepare()`` writes the ones that change (-lr, c1, c2) in place before
    each step, ``apply(grads, skip)`` updates on the device (a 0-dim bool
    ``skip`` keeps every tensor as it was), and ``commit(updated)``
    advances ``count``: the same split as ``FusedAdamW``, so that the
    device part can be captured. ``step(grads)`` does all three."""

    def __init__(self, params: Sequence[torch.Tensor],
                 lr: Union[float, Callable] = 1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, adam_w_mode: bool = True):
        self.params = list(params)
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.adam_w_mode = adam_w_mode
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        # per (dtype, device): 1 - b1, b1, 1 - b2, b2, eps, wd, -lr, c1, c2
        self._consts = {}
        for p in self.params:
            key = (p.dtype, p.device)
            if key not in self._consts:
                self._consts[key] = torch.tensor(
                    [1 - b1, b1, 1 - b2, b2, eps, weight_decay, 0.0, 1.0, 1.0],
                    dtype=p.dtype).to(p.device)

    def prepare(self):
        lr = float(self.lr(self.count) if callable(self.lr) else self.lr)
        count = self.count + 1
        # optax computes 1 - decay**count in f32, then casts to the moment
        # dtype; a Python constant takes the array's dtype (JAX weak typing),
        # so in bf16 even b1 is rounded to bf16 before it multiplies
        c1, c2 = (float(1.0 - torch.tensor(b, dtype=torch.float32) ** count)
                  for b in (self.b1, self.b2))
        for (dtype, _), buf in self._consts.items():
            src = torch.tensor([-lr, c1, c2], dtype=dtype)
            if buf.is_cuda:
                # a fresh pinned buffer: no sync, and the next step's values
                # cannot overwrite this one's before its copy has run
                buf[6:].copy_(src.pin_memory(), non_blocking=True)
            else:
                buf[6:].copy_(src)

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor],
              skip: Optional[torch.Tensor] = None):
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            (k_1mb1, k_b1, k_1mb2, k_b2, k_eps, k_wd, k_lr, k_c1,
             k_c2) = self._consts[(p.dtype, p.device)].unbind()
            if not self.adam_w_mode and self.weight_decay:
                g = g + k_wd * p
            m_new = k_1mb1 * g + k_b1 * m
            v_new = k_1mb2 * (g * g) + k_b2 * v
            u = (m_new / k_c1) / (torch.sqrt(v_new / k_c2) + k_eps)
            if self.adam_w_mode:
                u = u + k_wd * p
            if skip is None:
                m.copy_(m_new)
                v.copy_(v_new)
                p.add_(k_lr * u)
            else:
                m.copy_(torch.where(skip, m, m_new))
                v.copy_(torch.where(skip, v, v_new))
                p.copy_(torch.where(skip, p, p + k_lr * u))

    def commit(self, updated: bool = True):
        if updated:
            self.count += 1

    def step(self, grads: Sequence[torch.Tensor]):
        self.prepare()
        self.apply(grads)
        self.commit()


def build_optimizer(params: Sequence[torch.Tensor], opt_type: Optional[str],
                    opt_params: Optional[Dict[str, Any]] = None,
                    learning_rate: Union[float, Callable, None] = None,
                    use_pallas: bool = False):
    """Map a DeepSpeed optimizer block to an optimizer over ``params``.
    ``learning_rate`` is a float or a ``count -> lr`` schedule; None takes
    the block's ``lr``. ``use_pallas`` (the config's
    ``tpu.use_pallas_optimizer``) routes decoupled-decay Adam to B4."""
    opt_params = dict(opt_params or {})
    lr = learning_rate if learning_rate is not None else opt_params.get("lr", 1e-3)
    b1, b2 = _normalize_betas(opt_params)
    eps = float(opt_params.get("eps", 1e-8))
    wd = float(opt_params.get("weight_decay", 0.0))
    name = (opt_type or C.ADAMW_OPTIMIZER).lower()
    adam_w_mode = bool(opt_params.get("adam_w_mode", True))

    adam_family = (C.ADAM_OPTIMIZER, C.FUSED_ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER,
                   C.CPU_ADAM_OPTIMIZER)
    if use_pallas and adam_w_mode and name in adam_family[:3]:
        return FusedAdamW(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=wd)
    if name in adam_family:
        # reference FusedAdam defaults to adam_w_mode=True; AdamW is always
        # decoupled
        return AdamW(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                     adam_w_mode=adam_w_mode or name == C.ADAMW_OPTIMIZER)
    if name in (C.ADAGRAD_OPTIMIZER, C.CPU_ADAGRAD_OPTIMIZER, C.LAMB_OPTIMIZER,
                C.FUSED_LAMB_OPTIMIZER, C.SGD_OPTIMIZER) + C.ONEBIT_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported to deepspeed_tpu_torch yet")
    raise ValueError(f"Unknown optimizer type: {opt_type!r}")
