"""Fused AdamW on Hopper (counterpart of
``deepspeed_tpu/ops/pallas/fused_adam.py``: the kernel ``_adamw_kernel`` :26,
``fused_adamw_update`` :45 and the ``fused_adamw`` transformation :104).

``fused_adamw_apply`` updates lists of parameters and their f32 moments in
place: for CUDA tensors with ONE launch of ``csrc/fused_adamw.cu`` per
(param dtype, grad dtype) group (B4) over a device table of the tensors'
pointers, or raises; for CPU tensors with ``fused_adamw_reference``, the
plain PyTorch version. JAX returns new arrays; updating in place is what the
Pallas kernel's input/output aliasing (:88) does on the device.

The step's scalars live in a device f32 buffer ``[lr, c1, c2, skip]``, as
the Pallas kernel reads ``lr_ref``, ``c1_ref`` and ``c2_ref`` (:26-32): the
host writes lr, c1 and c2 before each step, and a step function on the card
may set ``skip`` (the fp16 overflow skip), so a captured CUDA graph replays
with each step's values and reads nothing back. ``fused_adamw_update`` is
the same update from host floats (lr, step).

Each parameter list's pointer table is built once and kept (parameters are
trained in place, so their pointers do not move); a table first needed
while a CUDA graph is captured is filled once the capture has ended, and the
graph holds it.

``FusedAdamW`` is the optimizer the engine builds for ``"FusedAdam"`` with
``tpu.use_pallas_optimizer``: a step count, f32 ``mu``/``nu``, and the
learning rate read from the schedule at the count BEFORE the increment.
"""

import collections
import ctypes
import functools
from typing import Callable, Dict, List, Optional, Union

import torch

from deepspeed_tpu_torch.ops.cuda.build import load_library
from deepspeed_tpu_torch.ops.cuda.common import check_current_device
from deepspeed_tpu_torch.runtime import compiled_step
from deepspeed_tpu_torch.runtime.optimizer_state import StatefulOptimizer

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# elements per (tensor, chunk) pair of the kernel's grid; a multiple of 8
CHUNK = 65536
# the step's scalars: indices into the device f32 buffer
S_LR, S_C1, S_C2, S_SKIP, N_SCALARS = 0, 1, 2, 3, 4
# pointer tables kept, least recently used first out
_TABLES_MAX = 16
_TABLES: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
# per (device, rows): an empty table buffer made outside any capture, for
# the next capture to take
_SPARES: Dict[tuple, torch.Tensor] = {}

# kernel launches since the count was last set to 0 (CPU calls never count)
launches = 0


@functools.cache
def _kernel():
    fn = load_library("fused_adamw").ds_fused_adamw
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    fn.argtypes = [ptr, i32, i64, i64, i32, i32, ptr] + [f32] * 6 + [ptr]
    fn.restype = i32
    return fn


def _bias_corrections(step, b1, b2):
    return 1.0 - b1 ** step, 1.0 - b2 ** step


def _host_scalars(lr, step, b1, b2, skip=False):
    """``[lr, c1, c2, skip]`` as an f32 CPU tensor: each rounded once from
    the host's double, as the float arguments of the kernel were."""
    c1, c2 = _bias_corrections(step, b1, b2)
    return torch.tensor([float(lr), c1, c2, float(skip)], dtype=torch.float32)


def write_adamw_scalars(buf: torch.Tensor, lr, step, b1, b2):
    """Write ``[lr, c1, c2, 0]`` for 1-based ``step`` into the f32 buffer
    ``buf``, in place and without a sync: on a card through a fresh pinned
    buffer (the caching host allocator keeps it until the copy has run), so
    the host may write the next step's values before this one has run."""
    src = _host_scalars(lr, step, b1, b2)
    if buf.is_cuda:
        buf.copy_(src.pin_memory(), non_blocking=True)
    else:
        buf.copy_(src)


def adamw_scalars(lr, step, b1, b2, device, skip=False) -> torch.Tensor:
    """A new ``[lr, c1, c2, skip]`` f32 buffer on ``device``."""
    return _host_scalars(lr, step, b1, b2, skip).to(device)


def fused_adamw_reference(params, grads, ms, vs, scalars, *, b1=0.9,
                          b2=0.999, eps=1e-8, weight_decay=0.0):
    """Plain PyTorch version of the kernel, op for op: g upcast to f32,
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``,
    ``p -= lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)`` in f32 with lr,
    c1 and c2 read from ``scalars`` (f32 ``[lr, c1, c2, skip]`` on the
    tensors' device), p stored back in its dtype; a nonzero ``skip`` leaves
    p, m and v as they were, decided on the device."""
    if not params:
        return
    # 0-dim device tensors: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently
    lr, c1, c2, skip = scalars.unbind()
    keep = skip != 0
    for p, g, m, v in zip(params, grads, ms, vs):
        gf = g.float()
        m_new = m * b1 + gf * (1.0 - b1)
        v_new = v * b2 + gf * (1.0 - b2) * gf
        update = (m_new / c1) / ((v_new / c2).sqrt_() + eps)
        pf = p.float()
        p_new = pf - lr * (update + weight_decay * pf)
        m.copy_(torch.where(keep, m, m_new))
        v.copy_(torch.where(keep, v, v_new))
        p.copy_(torch.where(keep, pf, p_new))


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


def _reserve(device, n_rows):
    key = (str(device), n_rows)
    if key not in _SPARES:
        _SPARES[key] = torch.empty((n_rows, 6), dtype=torch.int64, device=device)


def _fill(table, host, device):
    """After a capture: the table's rows, and a spare for the next one."""
    table.copy_(host)
    _reserve(device, host.shape[0])


def _table(group, device):
    """The kernel's tensor table: one int64 row (p, g, m, v, numel, first
    chunk) per non-empty tensor, on ``device``. Built once per set of
    pointers and kept: a new table is copied from pinned host memory without
    a sync. While a CUDA graph is captured no copy may run, and a buffer
    from the graph's memory pool may be one that earlier nodes of the same
    graph write on every replay, so the capture takes a spare buffer made
    outside it (by an uncaptured call with as many rows, as a warm-up step
    is) and fills it once the capture has ended; a graph holds the tables it
    uses. Returns ``(device table, rows, chunks)``."""
    rows, chunk0 = [], 0
    for p, g, m, v in group:
        n = p.numel()
        if n == 0:
            continue
        for x in (p, g, m, v):
            if not x.is_contiguous():
                raise ValueError("fused_adamw_update needs contiguous tensors")
        rows.append((p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                     n, chunk0))
        chunk0 += -(-n // CHUNK)
    if not rows:
        return None, 0, 0
    key = (str(device), tuple(rows))
    table = _TABLES.get(key)
    if table is None:
        host = torch.tensor(rows, dtype=torch.int64)
        if compiled_step.capturing():
            table = _SPARES.pop((str(device), len(rows)), None)
            if table is None:
                raise RuntimeError(
                    f"fused_adamw: no pointer table of {len(rows)} rows was "
                    "made before this CUDA graph capture; run the step "
                    "uncaptured first")
            compiled_step.after_capture(
                functools.partial(_fill, table, host, device))
        else:
            table = host.pin_memory().to(device, non_blocking=True)
            _reserve(device, len(rows))
        _TABLES[key] = table
        while len(_TABLES) > _TABLES_MAX:
            _TABLES.popitem(last=False)
    else:
        _TABLES.move_to_end(key)
    if compiled_step.capturing():
        compiled_step.hold(table)
    else:
        # made on one stream, maybe read on another before it is evicted
        table.record_stream(torch.cuda.current_stream(device))
    return table, len(rows), chunk0


def _launch(group, scalars, b1, b2, eps, weight_decay):
    global launches
    p0, g0 = group[0][0], group[0][1]
    check_current_device(p0)
    with torch.cuda.device(p0.device):
        table, n_rows, chunks = _table(group, p0.device)
        if n_rows == 0:
            return
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            table.data_ptr(), n_rows, chunks, CHUNK, _DTYPE_CODES[p0.dtype],
            _DTYPE_CODES[g0.dtype], scalars.data_ptr(), b1, 1.0 - b1, b2,
            1.0 - b2, eps, weight_decay, stream)
    if err:
        raise RuntimeError(f"fused_adamw kernel failed: CUDA error {err}")
    launches += 1


def fused_adamw_apply(params: List[torch.Tensor], grads, ms, vs,
                      scalars: torch.Tensor, *, b1=0.9, b2=0.999, eps=1e-8,
                      weight_decay=0.0):
    """One AdamW step over lists of tensors, in place: ``params`` (any float
    dtype), ``grads`` (any float dtype, read and upcast), f32 ``ms`` and
    ``vs``, with lr, c1, c2 and the skip flag read on the device from
    ``scalars`` (``[lr, c1, c2, skip]`` f32 on the tensors' device). CUDA
    tensors take one kernel launch per (param dtype, grad dtype) group and
    no host read, so a CUDA graph can hold the call. CPU tensors take
    ``fused_adamw_reference``."""
    params, grads, ms, vs = list(params), list(grads), list(ms), list(vs)
    if not params:
        return
    _check(params, grads, ms, vs)
    device = params[0].device
    if (scalars.dtype != torch.float32 or scalars.shape != (N_SCALARS,)
            or scalars.device != device):
        raise ValueError(f"scalars must be f32 [{N_SCALARS}] on {device}, got "
                         f"{scalars.dtype} {tuple(scalars.shape)} on "
                         f"{scalars.device}")
    if device.type == "cpu":
        fused_adamw_reference(params, grads, ms, vs, scalars, b1=b1, b2=b2,
                              eps=eps, weight_decay=weight_decay)
        return
    if device.type != "cuda":
        raise ValueError(f"fused_adamw_update runs on cuda or cpu, not {device}")
    groups: Dict[tuple, list] = {}
    for quad in zip(params, grads, ms, vs):
        groups.setdefault((quad[0].dtype, quad[1].dtype), []).append(quad)
    for group in groups.values():
        _launch(group, scalars, b1, b2, eps, weight_decay)


def fused_adamw_update(params: List[torch.Tensor], grads, ms, vs, lr: float,
                       step: int, *, b1=0.9, b2=0.999, eps=1e-8,
                       weight_decay=0.0):
    """``fused_adamw_apply`` from host floats: ``lr`` and the 1-based
    ``step`` of the bias corrections (one host-to-device copy of the
    scalars per call)."""
    params = list(params)
    if not params:
        return
    fused_adamw_apply(params, grads, ms, vs,
                      adamw_scalars(lr, step, b1, b2, params[0].device),
                      b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


class FusedAdamW(StatefulOptimizer):
    """AdamW on B4 with the state layout of the JAX ``fused_adamw``
    transformation: ``count``, and f32 ``mu``/``nu`` beside each parameter.
    ``lr`` is a float or a ``count -> lr`` schedule, evaluated at the count
    before the increment (optax's convention: the first step sees
    ``lr(0)``); the bias corrections use the 1-based step.

    A step is three calls, so that its device part can be captured:
    ``prepare(lr)`` writes lr (the schedule's, or the override ``lr``), c1
    and c2 for the next count into ``scalars`` on the host,
    ``apply(grads, skip)`` updates on the device (``skip``: a 0-dim bool
    tensor, the fp16 overflow flag, or None), and ``commit(updated)``
    advances ``count`` when the step updated: the host knows of an overflow
    before the next step, so a skipped step keeps the count, as the JAX
    ``skip_update`` branch keeps ``opt_state``. ``step(grads)`` does all
    three. ``state_dict()`` / ``load_state_dict()`` carry ``count``, ``mu``
    and ``nu`` by parameter name (``runtime/optimizer_state.py``)."""

    STATE = ("mu", "nu")

    def __init__(self, params, lr: Union[float, Callable] = 1e-3, b1=0.9,
                 b2=0.999, eps=1e-8, weight_decay=0.0, names=None):
        self.params = list(params)
        self._init_names(names)
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        device = self.params[0].device if self.params else "cpu"
        self.scalars = torch.zeros(N_SCALARS, dtype=torch.float32, device=device)

    def prepare(self, lr=None):
        write_adamw_scalars(self.scalars, self._lr_now(lr), self.count + 1,
                            self.b1, self.b2)

    @torch.no_grad()
    def apply(self, grads, skip: Optional[torch.Tensor] = None):
        if skip is not None:
            self.scalars[S_SKIP].copy_(skip)
        fused_adamw_apply(self.params, grads, self.mu, self.nu, self.scalars,
                          b1=self.b1, b2=self.b2, eps=self.eps,
                          weight_decay=self.weight_decay)
