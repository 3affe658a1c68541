"""Fused AdamW on Hopper (counterpart of
``deepspeed_tpu/ops/pallas/fused_adam.py``: the kernel ``_adamw_kernel`` :26,
``fused_adamw_update`` :45 and the ``fused_adamw`` transformation :104).

``fused_adamw_update`` updates lists of parameters and their f32 moments in
place: for CUDA tensors with ONE launch of ``csrc/fused_adamw.cu`` per
(param dtype, grad dtype) group (B4) over a device table of the tensors'
pointers, or raises; for CPU tensors with ``fused_adamw_reference``, the
plain PyTorch version. JAX returns new arrays; updating in place is what the
Pallas kernel's input/output aliasing (:88) does on the device.

``FusedAdamW`` is the optimizer the engine builds for ``"FusedAdam"`` with
``tpu.use_pallas_optimizer``: a step count, f32 ``mu``/``nu``, and the
learning rate read from the schedule at the count BEFORE the increment.
"""

import ctypes
import functools
from typing import Callable, Dict, List, Union

import torch

from deepspeed_tpu_torch.ops.cuda.build import load_library

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# elements per (tensor, chunk) pair of the kernel's grid; a multiple of 8
CHUNK = 65536

# kernel launches since the count was last set to 0 (CPU calls never count)
launches = 0


@functools.cache
def _kernel():
    fn = load_library("fused_adamw").ds_fused_adamw
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    fn.argtypes = [ptr, i32, i64, i64, i32, i32] + [f32] * 9 + [ptr]
    fn.restype = i32
    return fn


def _bias_corrections(step, b1, b2):
    return 1.0 - b1 ** step, 1.0 - b2 ** step


def fused_adamw_reference(params, grads, ms, vs, lr, step, *, b1=0.9,
                          b2=0.999, eps=1e-8, weight_decay=0.0):
    """Plain PyTorch version of the kernel, op for op: g upcast to f32,
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``,
    ``p -= lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)`` in f32 with the
    bias corrections from the host, p stored back in its dtype."""
    if not params:
        return
    # 0-dim device tensors: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently
    c1, c2 = (torch.tensor(c, dtype=torch.float32, device=params[0].device)
              for c in _bias_corrections(step, b1, b2))
    for p, g, m, v in zip(params, grads, ms, vs):
        gf = g.float()
        m.mul_(b1).add_(gf * (1.0 - b1))
        v.mul_(b2).add_(gf * (1.0 - b2) * gf)
        update = (m / c1) / ((v / c2).sqrt_() + eps)
        pf = p.float()
        pf.sub_(lr * (update + weight_decay * pf))
        p.copy_(pf)


def _check(params, grads, ms, vs):
    if not len(params) == len(grads) == len(ms) == len(vs):
        raise ValueError(
            f"params, grads, ms, vs differ in length: {len(params)}, "
            f"{len(grads)}, {len(ms)}, {len(vs)}")
    for i, (p, g, m, v) in enumerate(zip(params, grads, ms, vs)):
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"tensor {i}: shapes differ")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"tensor {i}: m and v must be float32")
        if p.dtype not in _DTYPE_CODES or g.dtype not in _DTYPE_CODES:
            raise ValueError(f"tensor {i}: p {p.dtype} / g {g.dtype} not in "
                             f"{list(_DTYPE_CODES)}")
        if not p.device == g.device == m.device == v.device == params[0].device:
            raise ValueError(f"tensor {i}: tensors on different devices")


def _table(group, device):
    """The kernel's tensor table: one int64 row (p, g, m, v, numel, first
    chunk) per non-empty tensor, copied to ``device`` from pinned host
    memory without a sync (the caching host allocator keeps the pinned
    buffer until the copy has run). Returns ``(device table, rows,
    chunks)``."""
    rows, chunk0 = [], 0
    for p, g, m, v in group:
        n = p.numel()
        if n == 0:
            continue
        for x in (p, g, m, v):
            if not x.is_contiguous():
                raise ValueError("fused_adamw_update needs contiguous tensors")
        rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     n, chunk0])
        chunk0 += -(-n // CHUNK)
    if not rows:
        return None, 0, 0
    table = torch.tensor(rows, dtype=torch.int64).pin_memory()
    return table.to(device, non_blocking=True), len(rows), chunk0


def _launch(group, lr, step, b1, b2, eps, weight_decay):
    global launches
    p0, g0 = group[0][0], group[0][1]
    with torch.cuda.device(p0.device):
        table, n_rows, chunks = _table(group, p0.device)
        if n_rows == 0:
            return
        c1, c2 = _bias_corrections(step, b1, b2)
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            table.data_ptr(), n_rows, chunks, CHUNK, _DTYPE_CODES[p0.dtype],
            _DTYPE_CODES[g0.dtype], lr, b1, 1.0 - b1, b2, 1.0 - b2, c1, c2,
            eps, weight_decay, stream)
    if err:
        raise RuntimeError(f"fused_adamw kernel failed: CUDA error {err}")
    launches += 1


def fused_adamw_update(params: List[torch.Tensor], grads, ms, vs, lr: float,
                       step: int, *, b1=0.9, b2=0.999, eps=1e-8,
                       weight_decay=0.0):
    """One AdamW step over lists of tensors, in place: ``params`` (any float
    dtype), ``grads`` (any float dtype, read and upcast), f32 ``ms`` and
    ``vs``; ``step`` is the 1-based step of the bias corrections. CUDA
    tensors take one kernel launch per (param dtype, grad dtype) group.
    CPU tensors take ``fused_adamw_reference``."""
    params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
    if not params:
        return
    _check(params, grads, ms, vs)
    device = params[0].device
    if device.type == "cpu":
        fused_adamw_reference(params, grads, ms, vs, lr, step, b1=b1, b2=b2,
                              eps=eps, weight_decay=weight_decay)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_adamw_update runs on cuda or cpu, not {device}")
    groups: Dict[tuple, list] = {}
    for quad in zip(params, grads, ms, vs):
        groups.setdefault((quad[0].dtype, quad[1].dtype), []).append(quad)
    for group in groups.values():
        _launch(group, float(lr), step, b1, b2, eps, weight_decay)


class FusedAdamW:
    """AdamW on B4 with the state layout of the JAX ``fused_adamw``
    transformation: ``count``, and f32 ``mu``/``nu`` beside each parameter.
    ``lr`` is a float or a ``count -> lr`` schedule, evaluated at the count
    before the increment (optax's convention: the first step sees
    ``lr(0)``); the bias corrections use the 1-based step."""

    def __init__(self, params, lr: Union[float, Callable] = 1e-3, b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=0.0):
        self.params = list(params)
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        lr = float(self.lr(self.count) if callable(self.lr) else self.lr)
        self.count += 1
        fused_adamw_update(self.params, grads, self.mu, self.nu, lr,
                           self.count, b1=self.b1, b2=self.b2, eps=self.eps,
                           weight_decay=self.weight_decay)

