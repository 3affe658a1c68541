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
and advances its own ``count`` only when it steps.
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
    ``count -> lr`` schedule read at the count before the increment."""

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

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]):
        lr = float(self.lr(self.count) if callable(self.lr) else self.lr)
        self.count += 1
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        # optax computes 1 - decay**count in f32, then casts to the moment
        # dtype; a Python constant takes the array's dtype (JAX weak typing),
        # so in bf16 even b1 is rounded to bf16 before it multiplies
        c1, c2 = (float(1.0 - torch.tensor(b, dtype=torch.float32) ** self.count)
                  for b in (b1, b2))
        consts = {}
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            key = (p.dtype, p.device)
            if key not in consts:
                consts[key] = [torch.tensor(x, dtype=p.dtype).to(p.device) for x in
                               (1 - b1, b1, 1 - b2, b2, self.eps, wd, -lr,
                                c1, c2)]
            k_1mb1, k_b1, k_1mb2, k_b2, k_eps, k_wd, k_lr, k_c1, k_c2 = consts[key]
            if not self.adam_w_mode and wd:
                g = g + k_wd * p
            m.copy_(k_1mb1 * g + k_b1 * m)
            v.copy_(k_1mb2 * (g * g) + k_b2 * v)
            u = (m / k_c1) / (torch.sqrt(v / k_c2) + k_eps)
            if self.adam_w_mode:
                u = u + k_wd * p
            p.add_(k_lr * u)


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
