"""Optimizer construction from the DeepSpeed config (counterpart of
``deepspeed_tpu/runtime/optimizer.py:34-134``).

The same rules as the JAX package: the Adam family with ``adam_w_mode``
(the default) and ``tpu.use_pallas_optimizer`` takes the fused kernel
(``ops/cuda/fused_adam.FusedAdamW``, B4); otherwise ``AdamW``, written out
in PyTorch with ``optax.adamw``'s arithmetic (moments in the parameter
dtype, the same bias correction and decoupled decay; ``torch.optim``'s
update order rounds differently), or with ``adam_w_mode=False`` Adam with
coupled L2 decay. LAMB (``optax.lamb``), Adagrad (``optax.adagrad``) and
SGD (``optax.sgd``) are written out the same way: optax's arithmetic in
the parameter dtype, and no kernel of their own (the JAX package has no
Pallas kernel for them either). The 1-bit family (``OneBitAdam``,
``OneBitLamb``, ``ZeroOneAdam``: ``runtime/fp16/onebit/``) takes the
compression axis and its size from the engine; without them it falls back
to its uncompressed update rule with the JAX warning.

Unlike an optax transformation, a PyTorch optimizer owns its state, so
``build_optimizer`` takes the parameters (and their names, which key
``state_dict()``). Every optimizer here has ``step(grads)``, with one
gradient per parameter in the parameter's dtype, and advances its own
``count`` only when it steps; and the same step in three parts,
``prepare(lr)`` (the host writes the step's scalars, the schedule's lr or
the override ``lr``, into device buffers), ``apply(grads, skip)`` (device
work only, which a CUDA graph can hold: the LAMB trust ratio's norms stay
on the device) and ``commit(updated)`` (the count).
"""

from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from deepspeed_tpu_torch.ops.cuda.fused_adam import FusedAdamW
from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.optimizer_state import StatefulOptimizer
from deepspeed_tpu_torch.utils.logging import logger


def _normalize_betas(params: Dict[str, Any]):
    betas = params.get("betas", (0.9, 0.999))
    return float(betas[0]), float(betas[1])


class _DeviceScalars:
    """The constants of an update as device scalars in each parameter
    dtype, made once per (dtype, device): ``fixed`` first, then ``n_step``
    slots that ``write`` fills before each step (in place, so that a
    captured step reads each step's values). A value rounds to the
    parameter dtype, as a Python constant takes an array's dtype under JAX's
    weak typing."""

    def __init__(self, params, fixed: Sequence[float], n_step: int):
        self.n_fixed = len(fixed)
        self.bufs = {}
        for p in params:
            key = (p.dtype, p.device)
            if key not in self.bufs:
                self.bufs[key] = torch.tensor(
                    list(fixed) + [0.0] * n_step, dtype=p.dtype).to(p.device)

    def write(self, values: Sequence[float]):
        for (dtype, _), buf in self.bufs.items():
            src = torch.tensor(list(values), dtype=dtype)
            if buf.is_cuda:
                # a fresh pinned buffer: no sync, and the next step's values
                # cannot overwrite this one's before its copy has run
                buf[self.n_fixed:].copy_(src.pin_memory(), non_blocking=True)
            else:
                buf[self.n_fixed:].copy_(src)

    def of(self, p):
        return self.bufs[(p.dtype, p.device)].unbind()


def _bias_corrections(b1, b2, count):
    # optax computes 1 - decay**count in f32, then casts to the moment
    # dtype; a Python constant takes the array's dtype (JAX weak typing),
    # so in bf16 even b1 is rounded to bf16 before it multiplies
    return [float(1.0 - torch.tensor(b, dtype=torch.float32) ** count)
            for b in (b1, b2)]


def _store(skip, pairs):
    """Write each ``(dst, new)``, or keep ``dst`` where the 0-dim bool
    ``skip`` is set (decided on the device)."""
    for dst, new in pairs:
        dst.copy_(new if skip is None else torch.where(skip, dst, new))


class AdamW(StatefulOptimizer):
    """Adam with ``optax.adamw``'s arithmetic, or with coupled L2 decay
    (``optax.chain(add_decayed_weights, adam)``) when ``adam_w_mode`` is
    False. ``mu``/``nu`` live in the parameter dtype; every operation runs
    in that dtype, in optax's order. ``lr`` is a float or a
    ``count -> lr`` schedule read at the count before the increment.

    The constants are device scalars in each parameter dtype, made once;
    ``prepare(lr)`` writes the ones that change (-lr, c1, c2) in place
    before each step, ``apply(grads, skip)`` updates on the device (a 0-dim
    bool ``skip`` keeps every tensor as it was), and ``commit(updated)``
    advances ``count``: the same split as ``FusedAdamW``, so that the
    device part can be captured. ``step(grads)`` does all three."""

    STATE = ("mu", "nu")

    def __init__(self, params: Sequence[torch.Tensor],
                 lr: Union[float, Callable] = 1e-3, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.0, adam_w_mode: bool = True,
                 names=None):
        self.params = list(params)
        self._init_names(names)
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.adam_w_mode = adam_w_mode
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        # 1 - b1, b1, 1 - b2, b2, eps, wd | -lr, c1, c2
        self._consts = _DeviceScalars(
            self.params, [1 - b1, b1, 1 - b2, b2, eps, weight_decay], 3)

    def prepare(self, lr=None):
        self._consts.write([-self._lr_now(lr)] + _bias_corrections(
            self.b1, self.b2, self.count + 1))

    def _moments(self, p, g, m, v):
        """optax's ``scale_by_adam``: the new moments and the update."""
        k_1mb1, k_b1, k_1mb2, k_b2, k_eps, _, _, k_c1, k_c2 = self._consts.of(p)
        m_new = k_1mb1 * g + k_b1 * m
        v_new = k_1mb2 * (g * g) + k_b2 * v
        return m_new, v_new, (m_new / k_c1) / (torch.sqrt(v_new / k_c2) + k_eps)

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor],
              skip: Optional[torch.Tensor] = None):
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            k_wd, k_lr = self._consts.of(p)[5:7]
            if not self.adam_w_mode and self.weight_decay:
                g = g + k_wd * p
            m_new, v_new, u = self._moments(p, g, m, v)
            if self.adam_w_mode:
                u = u + k_wd * p
            _store(skip, ((m, m_new), (v, v_new), (p, p + k_lr * u)))


class Lamb(AdamW):
    """``optax.lamb``: ``scale_by_adam``, decoupled weight decay, then
    ``scale_by_trust_ratio`` (each update scaled by ``|p| / |u|`` per
    parameter, 1 where either norm is 0), then ``-lr``. The norms are
    taken on the device (``torch._foreach_norm``), so the step reads
    nothing back and can be captured.

    Over ZeRO's flat shards (``runtime/zero/stage_1_and_2.py``) a tensor
    holds pieces of many parameters, and one parameter may straddle two
    ranks: ``runs`` gives, per tensor, the runs ``(leaf, a, b)`` that cover
    it (``leaf`` = ``n_leaves`` over padding) and ``n_leaves``. Each leaf's
    piece of the local shard is a view; the f32 norms of the pieces of p
    and u (``torch._foreach_norm``, deterministic) are squared into a
    ``[2, n_leaves]`` vector, ``reduce`` sums it over the ranks (one
    all-reduce), and each element takes its parameter's ratio."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0, names=None, runs=None, reduce=None):
        super().__init__(params, lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay, names=names)
        self.reduce = reduce
        self.runs = None
        if runs is not None:
            # per tensor: its leaf runs' ranges, and on the device each
            # leaf run's leaf, each run's leaf and each run's length
            self.runs = []
            for p, (rs, n) in zip(self.params, runs):
                def on(xs):
                    return torch.tensor(xs, dtype=torch.int64, device=p.device)
                self.runs.append((
                    [(a, b) for i, a, b in rs if i < n],
                    on([i for i, _, _ in rs if i < n]),
                    on([i for i, _, _ in rs]), on([b - a for _, a, b in rs]),
                    n))

    def _ratios(self, updates):
        """The trust ratio of each tensor (0-dim), or of each element."""
        if self.runs is None:
            p_norms = torch._foreach_norm(self.params)
            u_norms = torch._foreach_norm(updates)
            return [torch.where((pn == 0) | (un == 0), 1.0, pn / un)
                    for pn, un in zip(p_norms, u_norms)]
        out = []
        for p, u, (leaf_runs, leaves, run_leaf, lengths, n) in zip(
                self.params, updates, self.runs):
            sums = torch.zeros((2, n), dtype=torch.float32, device=p.device)
            for row, x in zip(sums, (p, u)):
                if leaf_runs:  # a shard of padding only holds no leaf
                    norms = torch._foreach_norm(
                        [x[a:b] for a, b in leaf_runs], 2,
                        dtype=torch.float32)
                    row.index_copy_(0, leaves, torch.stack(norms).square())
            if self.reduce is not None:
                self.reduce(sums)
            pn, un = sums.sqrt().to(p.dtype).unbind()
            ratio = torch.where((pn == 0) | (un == 0), 1.0, pn / un)
            # padding takes a ratio of 1 (its update is 0)
            ratio = torch.cat([ratio, ratio.new_ones(1)])
            out.append(ratio[run_leaf].repeat_interleave(
                lengths, output_size=p.numel()))
        return out

    @torch.no_grad()
    def apply(self, grads, skip=None):
        moments, updates = [], []
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m_new, v_new, u = self._moments(p, g, m, v)
            moments.append((m_new, v_new))
            updates.append(u + self._consts.of(p)[5] * p)
        for p, m, v, (m_new, v_new), u, ratio in zip(
                self.params, self.mu, self.nu, moments, updates,
                self._ratios(updates)):
            _store(skip, ((m, m_new), (v, v_new),
                          (p, p + self._consts.of(p)[6] * (u * ratio))))


class Adagrad(StatefulOptimizer):
    """``optax.adagrad``: ``sum_of_squares`` starts at
    ``initial_accumulator_value`` (0.1), adds ``g * g`` each step, and the
    update is ``g * where(s > 0, rsqrt(s + eps), 0)``, then ``-lr``."""

    STATE = ("sum_of_squares",)

    def __init__(self, params, lr=1e-3, eps=1e-7,
                 initial_accumulator_value=0.1, names=None):
        self.params = list(params)
        self._init_names(names)
        self.lr, self.eps = lr, eps
        self.count = 0
        self.sum_of_squares = [torch.full_like(p, initial_accumulator_value)
                               for p in self.params]
        self._consts = _DeviceScalars(self.params, [eps], 1)  # eps | -lr

    def prepare(self, lr=None):
        self._consts.write([-self._lr_now(lr)])

    @torch.no_grad()
    def apply(self, grads, skip=None):
        for p, g, s in zip(self.params, grads, self.sum_of_squares):
            k_eps, k_lr = self._consts.of(p)
            s_new = g * g + s
            u = torch.where(s_new > 0, torch.rsqrt(s_new + k_eps), 0.0) * g
            _store(skip, ((s, s_new), (p, p + k_lr * u)))


class SGD(StatefulOptimizer):
    """``optax.sgd`` with a momentum (the JAX package's ``build_optimizer``
    always passes one, so momentum 0 still keeps a ``trace``): ``t = g +
    momentum * t``, the update ``t`` (or ``g + momentum * t`` with
    ``nesterov``), then ``-lr``. Weight decay is not applied, as the JAX
    ``build_optimizer`` does not pass it."""

    STATE = ("trace",)

    def __init__(self, params, lr=1e-3, momentum=0.0, nesterov=False,
                 names=None):
        self.params = list(params)
        self._init_names(names)
        self.lr, self.momentum, self.nesterov = lr, momentum, nesterov
        self.count = 0
        self.trace = [torch.zeros_like(p) for p in self.params]
        self._consts = _DeviceScalars(self.params, [momentum], 1)  # mom | -lr

    def prepare(self, lr=None):
        self._consts.write([-self._lr_now(lr)])

    @torch.no_grad()
    def apply(self, grads, skip=None):
        for p, g, t in zip(self.params, grads, self.trace):
            k_mom, k_lr = self._consts.of(p)
            t_new = g + k_mom * t
            u = g + k_mom * t_new if self.nesterov else t_new
            _store(skip, ((t, t_new), (p, p + k_lr * u)))


def is_compressed_optimizer(opt_type: Optional[str]) -> bool:
    """True for the 1-bit family (the compressed-communication
    optimizers; JAX :29)."""
    return (opt_type or "").lower() in C.ONEBIT_OPTIMIZERS


def build_optimizer(params: Sequence[torch.Tensor], opt_type: Optional[str],
                    opt_params: Optional[Dict[str, Any]] = None,
                    learning_rate: Union[float, Callable, None] = None,
                    use_pallas: bool = False,
                    names: Optional[Sequence[str]] = None,
                    runs=None, reduce=None,
                    compression_axis: Optional[str] = None,
                    compression_axis_size: Optional[int] = None,
                    layout=None):
    """Map a DeepSpeed optimizer block to an optimizer over ``params``
    (named ``names``, by default their positions). ``runs`` and
    ``reduce`` describe flat ZeRO shards to LAMB, the one optimizer here
    whose update is not elementwise (see ``Lamb``).
    ``learning_rate`` is a float or a ``count -> lr`` schedule; None takes
    the block's ``lr``. ``use_pallas`` (the config's
    ``tpu.use_pallas_optimizer``) routes decoupled-decay Adam to B4. The
    1-bit family takes ``compression_axis`` and its size (the engine's dp
    axis) and ``layout`` (the flat layout of its state and exchange,
    ``ExchangeLayout``); it steps on per-worker gradients."""
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
        return FusedAdamW(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                          names=names)
    if name in adam_family:
        # reference FusedAdam defaults to adam_w_mode=True; AdamW is always
        # decoupled
        return AdamW(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                     adam_w_mode=adam_w_mode or name == C.ADAMW_OPTIMIZER,
                     names=names)
    if name in (C.ADAGRAD_OPTIMIZER, C.CPU_ADAGRAD_OPTIMIZER):
        return Adagrad(params, lr, eps=float(opt_params.get("eps", 1e-10)),
                       names=names)
    if name in (C.LAMB_OPTIMIZER, C.FUSED_LAMB_OPTIMIZER):
        return Lamb(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                    names=names, runs=runs, reduce=reduce)
    if name == C.SGD_OPTIMIZER:
        return SGD(params, lr, momentum=float(opt_params.get("momentum", 0.0)),
                   nesterov=bool(opt_params.get("nesterov", False)),
                   names=names)
    if name in C.ONEBIT_OPTIMIZERS:
        if compression_axis is not None and compression_axis_size is not None:
            from deepspeed_tpu_torch.runtime.fp16.onebit import (
                OnebitAdam, OnebitLamb, ZeroOneAdam)

            # reference OnebitAdam calls the warmup length freeze_step
            warmup = int(opt_params.get(
                "freeze_step", opt_params.get("warmup_steps", 100)))
            common = dict(b1=b1, b2=b2, eps=eps, weight_decay=wd,
                          axis=compression_axis,
                          axis_size=compression_axis_size, names=names,
                          layout=layout)
            if name == C.ONEBIT_LAMB_OPTIMIZER:
                return OnebitLamb(params, lr, warmup_steps=warmup, **common)
            if name == C.ZERO_ONE_ADAM_OPTIMIZER:
                if "freeze_step" in opt_params:
                    logger.warning(
                        "ZeroOneAdam has no full-precision warmup stage "
                        "(0/1 Adam compresses from step 1; the variance "
                        "refresh period governs accuracy) — freeze_step "
                        "is ignored")
                return ZeroOneAdam(params, lr, var_update_period=int(
                    opt_params.get("var_update_period", 16)), **common)
            return OnebitAdam(params, lr, warmup_steps=warmup, **common)
        logger.warning(
            "%s: no mesh axis provided; using the uncompressed inner "
            "optimizer (the engine wires the compressed exchange)", opt_type)
        if "lamb" in name:
            return Lamb(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                        names=names, runs=runs, reduce=reduce)
        return AdamW(params, lr, b1=b1, b2=b2, eps=eps, weight_decay=wd,
                     names=names)
    raise ValueError(f"Unknown optimizer type: {opt_type!r}")
