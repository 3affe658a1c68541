"""Quantized (compressed) all-reduce (counterpart of
``deepspeed_tpu/comm/compressed.py``): the EQuARX-style int8 exchange, in
which both phases of an all-reduce move int8 payloads with one f32 scale
per block instead of the full-precision tensor.

Over ``w`` ranks of ``axis`` (or of this rank's part of
``axis_index_groups``), with the blockwise int8 of ``ops/quantizer.py``:

1. quantize the local tensor (padded to a multiple of ``w * block``);
2. all-to-all the int8 payload and its scales, so that rank r holds every
   rank's copy of shard r; dequantize and sum them in f32, in rank order;
3. quantize the reduced shard again (with the server residual of the last
   step added, for error feedback), all-gather it and its scales, and
   dequantize.

The collectives are the port's synchronous ``comm`` calls, so a captured
step holds them. At 2 ranks the dequantized sums are ``a + b`` in f32 on
both sides, so on the same inputs the results and residuals are the JAX
function's bit for bit; at more ranks the order of the sum may differ from
XLA's by rounding.
"""

from typing import Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.ops.quantizer import (dequantize,
                                               quantize_blockwise)


def server_shard_length(n: int, w: int, block: int = 512) -> int:
    """The length of one rank's reduced shard in
    :func:`quantized_all_reduce` (``n`` padded to a multiple of ``w *
    block``, over ``w``): the shape of the phase-2 error-feedback buffer."""
    return (n + ((-n) % (w * block))) // w


def _world(axis, axis_index_groups) -> int:
    return (comm.index_group(axis, axis_index_groups)[1]
            if axis_index_groups is not None else comm.comm._world_of(axis))


def _pad(flat: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def quantized_all_reduce(x: torch.Tensor, axis, block: int = 512,
                         return_error: bool = False,
                         server_error: Optional[torch.Tensor] = None,
                         log_name: str = "quantized_all_reduce",
                         axis_index_groups=None, level=None):
    """The sum of ``x`` over ``axis`` with the int8 wire (JAX :46), in
    ``x``'s shape and dtype; with ``return_error`` also the f32 phase-1
    residual ``x - dequant(quant(x))`` (error feedback for the next step).
    ``server_error`` (this rank's ``[server_shard_length(x.numel(), w,
    block)]`` f32 residual of the last step) is added to the reduced shard
    before phase 2, and the new one is returned third: ``(out, worker_err,
    new_server_error)``. The payload is logged under ``log_name``, its
    scales under ``<log_name>.scales``, with ``level`` ("ici"/"dcn")."""
    w = _world(axis, axis_index_groups)
    shape, dtype = x.shape, x.dtype
    flat = x.float().reshape(-1)
    n = flat.numel()
    pad = (-n) % (w * block)
    flat = _pad(flat, pad)
    per = flat.numel() // w

    # phase 1: every rank's int8 copy of this rank's shard, summed in f32
    q, s = quantize_blockwise(flat, block)
    kw = dict(axis_index_groups=axis_index_groups, level=level)
    q_recv = comm.all_to_all_single(q, axis, log_name=log_name, **kw)
    s_recv = comm.all_to_all_single(s, axis, log_name=f"{log_name}.scales",
                                    **kw)
    contribs = (q_recv.view(w, per // block, block).float()
                * s_recv.view(w, per // block)[..., None])
    reduced = contribs[0].clone()
    for i in range(1, w):
        reduced += contribs[i]
    reduced = reduced.reshape(per)
    if server_error is not None:
        reduced = reduced + server_error

    # phase 2: the reduced shard requantized and gathered
    q2, s2 = quantize_blockwise(reduced, block)
    q_all = comm.all_gather(q2, axis, log_name=log_name, **kw)
    s_all = comm.all_gather(s2, axis, log_name=f"{log_name}.scales", **kw)
    out = dequantize(q_all, s_all)[:n].reshape(shape).to(dtype)
    if not return_error and server_error is None:
        return out
    err = (flat - dequantize(q, s))[:n].reshape(shape)
    if server_error is None:
        return out, err
    return out, err, reduced - dequantize(q2, s2)


def quantization_error(x: torch.Tensor, block: int = 512) -> torch.Tensor:
    """The f32 residual ``x - dequant(quant(x))`` (JAX :155)."""
    flat = x.float().reshape(-1)
    n = flat.numel()
    flat = _pad(flat, (-n) % block)
    q, s = quantize_blockwise(flat, block)
    return (flat - dequantize(q, s))[:n].reshape(x.shape)
