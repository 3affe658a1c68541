"""1-bit Adam (counterpart of ``deepspeed_tpu/runtime/fp16/onebit/adam.py``):
error-compensated sign compression of the momentum exchange.

Adam runs exactly for ``warmup_steps`` (the mean gradient over the axis,
one f32 all-reduce); then the variance is frozen and each step the
momentum is updated with the rank's OWN gradient and exchanged by
:func:`compressed_allreduce`: int8 signs and one f32 scale per rank, with
error feedback on the worker side and on the server side.

``OnebitAdam`` is a ``torch.optim``-shaped optimizer over per-worker
gradients (not averaged: the compression is the exchange). Its state is
f32 and flat in a layout (``module_inject/jax_params.py``
``ExchangeLayout``): the engine passes the JAX engine's layout of a GPT,
so each leaf's sign chunks (``n / k`` elements per rank, padded) are the
JAX ones; standalone, each parameter is a leaf. The step is split as the
port's other optimizers split it: ``prepare(lr)`` writes -lr and the bias
corrections into a device buffer, ``apply(grad, phase, skip)`` is device
work only (a CUDA graph holds it; the exchange's collectives included),
``commit(updated)`` advances the count. The phase (``phase()``: warm-up or
compressed, the JAX ``lax.cond`` on the count) is a host value: the engine
captures one graph per phase.
"""

from typing import Callable, Optional, Sequence, Union

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.module_inject.jax_params import ExchangeLayout
from deepspeed_tpu_torch.runtime.optimizer_state import StatefulOptimizer

WARMUP, COMPRESSED = "warmup", "compressed"


def padded_length(n: int, k: int) -> int:
    """``n`` rounded up to a multiple of the axis size ``k``."""
    return -(-n // k) * k


def _pad_to(flat: torch.Tensor, n_pad: int) -> torch.Tensor:
    n = flat.shape[0]
    if n == n_pad:
        return flat
    return torch.cat([flat, flat.new_zeros(n_pad - n)])


def _compress(x: torch.Tensor, error: torch.Tensor,
              n_valid: Optional[int] = None):
    """Sign compression with error feedback (JAX :41): ``(signs int8, scale,
    new_error)``, the scale the mean ``|x + error|`` (the l1-best 1-bit
    approximation). ``n_valid``: the elements from it on are padding, left
    out of the scale, their feedback held at 0."""
    corrected = x + error
    if n_valid is not None:
        corrected[n_valid:] = 0.0
        scale = corrected.abs().sum() / max(n_valid, 1)
    else:
        scale = corrected.abs().mean()
    signs = torch.where(corrected >= 0, 1, -1).to(torch.int8)
    new_error = corrected - scale * signs.to(x.dtype)
    if n_valid is not None:
        new_error[n_valid:] = 0.0
    return signs, scale, new_error


def _sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """The sum of ``rows`` over dim 0, in rank order."""
    out = rows[0].clone()
    for i in range(1, rows.shape[0]):
        out += rows[i]
    return out


def compressed_allreduce(x: torch.Tensor, worker_error: torch.Tensor,
                         server_error: torch.Tensor, axis,
                         n_valid: Optional[int] = None,
                         log_name: str = "compressed_allreduce"):
    """The error-compensated MEAN of ``x`` over ``axis`` (JAX :68):
    ``x`` and ``worker_error`` ``[n]`` (n a multiple of the axis size k),
    ``server_error`` ``[n / k]``; ``n_valid`` the unpadded length. Returns
    ``(mean, new_worker_error, new_server_error)``. Phase 1 all-to-alls
    the int8 signs (chunk j to rank j) and all-gathers the f32 scales as
    ``[1]`` tensors; each rank sums its chunk and compresses it again with
    its server error; phase 2 all-gathers those signs and scales. Logged
    as ``log_name`` (signs) and ``<log_name>.scales``."""
    k = comm.comm._world_of(axis)
    n = x.shape[0]
    if n % k:
        raise ValueError(f"tensor length {n} must be divisible by axis "
                         f"size {k}; pad first")
    chunk = n // k
    padded = n_valid is not None and n_valid < n
    signs, scale, new_worker_error = _compress(
        x, worker_error, n_valid if padded else None)
    recv = comm.all_to_all_single(signs, axis, log_name=log_name)
    scales = comm.all_gather(scale.reshape(1), axis,
                             log_name=f"{log_name}.scales")
    server_chunk = _sum_rows(recv.view(k, chunk).float()
                             * scales[:, None]) / k
    valid2 = None
    if padded:
        j = comm.axis_index(axis) if isinstance(axis, str) else comm.get_rank()
        valid2 = min(max(n_valid - j * chunk, 0), chunk)
    s_signs, s_scale, new_server_error = _compress(server_chunk,
                                                   server_error, valid2)
    all_signs = comm.all_gather(s_signs, axis, log_name=log_name)
    all_scales = comm.all_gather(s_scale.reshape(1), axis,
                                 log_name=f"{log_name}.scales")
    result = (all_signs.view(k, chunk).float()
              * all_scales[:, None]).reshape(n)
    return result, new_worker_error, new_server_error


def _f32_pow_complement(b: float, exponent: int) -> float:
    """``1 - b ** exponent`` in f32, as the JAX step computes it."""
    return float(1.0 - torch.tensor(b, dtype=torch.float32) ** exponent)


def _store(skip, pairs):
    """Write each ``(dst, new)``, or keep ``dst`` where the 0-dim bool
    ``skip`` is set (decided on the device)."""
    for dst, new in pairs:
        dst.copy_(new if skip is None else torch.where(skip, dst, new))


class OnebitAdam(StatefulOptimizer):
    """1-bit Adam over ``params`` (JAX ``onebit_adam`` :136): f32
    ``exp_avg``/``exp_avg_sq`` flat in ``layout``, and per leaf a worker
    error of ``padded_length(n, k)`` and a server error of a k-th of it.
    ``lr`` is a float or a ``count -> lr`` schedule read at the count
    before the increment; the variance's bias correction uses the count
    clamped to ``[1, warmup_steps]``."""

    STATE = ("exp_avg", "exp_avg_sq")

    def __init__(self, params: Sequence[torch.Tensor],
                 lr: Union[float, Callable] = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, warmup_steps: int = 100,
                 axis="dp", axis_size: Optional[int] = None, names=None,
                 layout: Optional[ExchangeLayout] = None):
        if axis_size is None:
            raise ValueError("pass axis_size (dp world size) so server "
                             "error buffers can be shaped")
        self.params = list(params)
        self._init_names(names)
        self.layout = layout or ExchangeLayout.identity(
            [(n, p.shape) for n, p in zip(self.names, self.params)])
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.warmup_steps = int(warmup_steps)
        self.axis, self.k = axis, int(axis_size)
        self.count = 0
        dev = self.params[0].device
        self.exp_avg = torch.zeros(self.layout.numel, device=dev)
        self.exp_avg_sq = torch.zeros(self.layout.numel, device=dev)
        self.worker_error = [torch.zeros(padded_length(n, self.k), device=dev)
                             for n in self.layout.leaf_sizes]
        self.server_error = [torch.zeros(padded_length(n, self.k) // self.k,
                                         device=dev)
                             for n in self.layout.leaf_sizes]
        # -lr, the two bias corrections: written by prepare()
        self.scalars = torch.zeros(3, device=dev)
        self._wd = {p.dtype: torch.tensor(weight_decay, dtype=p.dtype,
                                          device=dev) for p in self.params}

    # -- the host side -----------------------------------------------------
    def phase(self) -> tuple:
        """The next step's branch, a host value (JAX ``in_warmup``)."""
        return ((WARMUP,) if self.count + 1 <= self.warmup_steps
                else (COMPRESSED,))

    def _biases(self, count: int):
        return (_f32_pow_complement(self.b1, count),
                _f32_pow_complement(
                    self.b2, max(min(count, self.warmup_steps), 1)))

    def prepare(self, lr=None):
        values = torch.tensor([-self._lr_now(lr), *self._biases(self.count + 1)],
                              dtype=torch.float32)
        if self.scalars.is_cuda:
            self.scalars.copy_(values.pin_memory(), non_blocking=True)
        else:
            self.scalars.copy_(values)

    # -- the device side ---------------------------------------------------
    # A step runs leaf by leaf (the layout's leaves, in order): the new
    # moments of a leaf, its exchange, its error feedback and its
    # parameters, so the step's temporaries are a few times the largest
    # leaf's, not the model's (at GPT-2 1.3B: wte, 0.4 GB in f32).
    def _mean(self, g: torch.Tensor, log_name: str) -> torch.Tensor:
        """The exact mean of ``g`` over the axis (JAX ``pmean``)."""
        return comm.all_reduce(g.clone(), self.axis,
                               log_name=log_name).div_(self.k)

    def _exchange(self, li: int, local_m: torch.Tensor):
        """Leaf ``li``'s momentum through :func:`compressed_allreduce`;
        returns it and the leaf's new error buffers."""
        n = self.layout.leaf_sizes[li]
        we, se = self.worker_error[li], self.server_error[li]
        red, we2, se2 = compressed_allreduce(_pad_to(local_m, we.shape[0]),
                                             we, se, self.axis, n_valid=n)
        return red[:n], [(we, we2), (se, se2)]

    def _leaf_moments(self, li: int, g: torch.Tensor, phase: str):
        """Leaf ``li``'s ``(exp_avg, exp_avg_sq, [(error, new error)])``."""
        m, v = (self.layout.leaf(buf, li)
                for buf in (self.exp_avg, self.exp_avg_sq))
        if phase == WARMUP:
            g_avg = self._mean(g, "onebit_warmup")
            return (self.b1 * m + (1 - self.b1) * g_avg,
                    self.b2 * v + (1 - self.b2) * g_avg * g_avg, [])
        m_new, errors = self._exchange(li, self.b1 * m + (1 - self.b1) * g)
        return m_new, v, errors

    def _direction(self, i: int):
        """Parameter ``i``'s ``m / bias1 / (sqrt(v / bias2) + eps)`` from
        the stored moments (f32, in the parameter's shape)."""
        _, bias1, bias2 = self.scalars.unbind()
        return (self.layout.view(self.exp_avg, i) / bias1
                / (torch.sqrt(self.layout.view(self.exp_avg_sq, i) / bias2)
                   + self.eps))

    def _new_params(self, members):
        """The new values of the parameters ``members`` (one leaf's)."""
        neg_lr = self.scalars[0]
        out = []
        for i in members:
            p, upd = self.params[i], self._direction(i)
            if self.weight_decay > 0:
                upd = upd + self._wd[p.dtype] * p
            out.append(p + (neg_lr * upd).to(p.dtype))
        return out

    def _gather_grad(self, grads) -> torch.Tensor:
        """Per-parameter gradients as one f32 flat buffer in the layout."""
        flat = torch.empty(self.layout.numel, device=self.exp_avg.device)
        for i, g in enumerate(grads):
            self.layout.view(flat, i).copy_(g)
        return flat

    @torch.no_grad()
    def apply(self, grad, phase: Optional[str] = None,
              skip: Optional[torch.Tensor] = None):
        """One step from this rank's own gradient: ``grad`` a flat f32
        buffer in the layout (or one gradient per parameter). ``phase``
        defaults to ``phase()``; ``skip`` (a 0-dim device bool) keeps every
        tensor, the error buffers included, as it was. The moments are
        stored before the parameters are updated from them: under ``skip``
        they are the old ones, and so is every parameter."""
        if not torch.is_tensor(grad):
            grad = self._gather_grad(grad)
        phase = phase or self.phase()[0]
        for li, members in enumerate(self.layout.leaf_params):
            g = self.layout.leaf(grad, li).float()
            m, v, errors = self._leaf_moments(li, g, phase)
            _store(skip, [(self.layout.leaf(self.exp_avg, li), m),
                          (self.layout.leaf(self.exp_avg_sq, li), v)]
                   + errors)
            del m, v, errors
            _store(skip, list(zip([self.params[i] for i in members],
                                  self._new_params(members))))

    # -- state by parameter name -------------------------------------------
    def state_dict(self):
        """``{"count", "state": {name: {"exp_avg", "exp_avg_sq"}}}`` in each
        parameter's shape (copies); the error buffers are
        ``exchange_state()``."""
        return {"count": self.count,
                "state": {name: {key: self.layout.view(getattr(self, key), i)
                                 .clone(memory_format=torch.contiguous_format)
                                 for key in self.STATE}
                          for i, name in enumerate(self.names)}}

    @torch.no_grad()
    def load_state_dict(self, sd):
        state = sd["state"]
        missing = [n for n in self.names if n not in state]
        unknown = [n for n in state if n not in set(self.names)]
        if missing or unknown:
            raise KeyError(f"optimizer state: missing {missing}, "
                           f"unknown {unknown}")
        for i, name in enumerate(self.names):
            for key in self.STATE:
                dst = self.layout.view(getattr(self, key), i)
                src = state[name][key]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"optimizer state {name}.{key}: shape "
                        f"{tuple(src.shape)}, want {tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(sd["count"])

    def exchange_state(self):
        """The error-feedback buffers, per leaf in the layout's order."""
        return {"worker_error": self.worker_error,
                "server_error": self.server_error}
