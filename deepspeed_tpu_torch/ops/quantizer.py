"""Quantization ops (counterpart of ``deepspeed_tpu/ops/quantizer.py``, the
whole module): grouped symmetric and asymmetric int8 quantization, its
inverse, the blockwise format of the compressed wire (``comm/compressed.py``)
and the per-column int8 weights.

These are elementwise ops and per-group reductions, which XLA fuses in the
JAX package (no Pallas kernel there), so here they are plain PyTorch. The
arithmetic is the JAX module's as XLA compiles it, in f32 and in its
order: the scale is ``max|x|`` times the f32 reciprocal of 127 (XLA turns
a division by a constant into that product; a division by a tensor, such
as ``x / scale``, stays a division) clamped at 1e-12, ``round`` is half to
even on both sides and the clip is to [-128, 127], so the same inputs give
the JAX engine's int8 codes and scales bit for bit. Stochastic rounding draws its noise from a ``torch.Generator``
(``rng``) in place of a JAX PRNG key, so its codes differ from the JAX
ones.
"""

from typing import Optional, Tuple

import numpy as np
import torch


def _grouped(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    n = x.numel()
    assert n % num_groups == 0, (
        f"size {n} not divisible into {num_groups} groups")
    return x.reshape(num_groups, n // num_groups)


def _qmax(num_bits: int) -> float:
    return float(2 ** (num_bits - 1) - 1)


def _over(x: torch.Tensor, const: float) -> torch.Tensor:
    """``x / const`` as compiled XLA computes it: ``x`` times the f32
    reciprocal of ``const``."""
    return x * float(np.float32(1.0) / np.float32(const))


def quantize(x: torch.Tensor, num_bits: int = 8, num_groups: int = 1,
             symmetric: bool = True, stochastic: bool = False,
             rng: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``(q, scale, zero_point)`` with one f32 scale per group (JAX
    ``quantize``). Symmetric: ``q = round(x / scale)``, ``scale = max|x| /
    qmax``; asymmetric: affine with the group's minimum as zero point.
    ``stochastic`` adds uniform noise in [-0.5, 0.5) before the floor."""
    orig_shape = x.shape
    g = _grouped(x.float(), num_groups)
    qmax = _qmax(num_bits)
    if symmetric:
        scale = torch.clamp(_over(g.abs().amax(dim=-1, keepdim=True), qmax),
                            min=1e-12)
        scaled = g / scale
        zero_point = None
    else:
        lo = g.amin(dim=-1, keepdim=True)
        hi = g.amax(dim=-1, keepdim=True)
        scale = torch.clamp(_over(hi - lo, 2 ** num_bits - 1), min=1e-12)
        zero_point = lo
        scaled = (g - lo) / scale - qmax - 1
    if stochastic:
        assert rng is not None, "stochastic rounding needs a generator"
        noise = torch.rand(scaled.shape, generator=rng,
                           device=scaled.device) - 0.5
        q = torch.floor(scaled + 0.5 + noise)
    else:
        q = torch.round(scaled)
    q = torch.clamp(q, -qmax - 1, qmax).to(
        torch.int8 if num_bits <= 8 else torch.int32).reshape(orig_shape)
    return q, scale[:, 0], (zero_point[:, 0] if zero_point is not None
                            else None)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero_point: Optional[torch.Tensor] = None, num_bits: int = 8,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize`."""
    g = _grouped(q.float(), scale.shape[0])
    if zero_point is None:
        out = g * scale[:, None]
    else:
        out = (g + _qmax(num_bits) + 1) * scale[:, None] + zero_point[:, None]
    return out.reshape(q.shape).to(dtype)


def quantize_blockwise(x: torch.Tensor, block: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one f32 scale per ``block`` consecutive elements
    of the last axis: ``q`` in ``x``'s shape, ``scale`` of shape
    ``x.shape[:-1] + (x.shape[-1] // block,)``."""
    assert x.shape[-1] % block == 0, (
        f"trailing axis {x.shape[-1]} not divisible by block {block}")
    q, scale, _ = quantize(x, num_bits=8, num_groups=x.numel() // block)
    return q, scale.reshape(tuple(x.shape[:-1]) + (x.shape[-1] // block,))


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`."""
    g = q.reshape(tuple(scale.shape) + (-1,)).float()
    return (g * scale[..., None]).reshape(q.shape).to(dtype)


def fake_quantize(x, num_bits=8, num_groups=1, symmetric=True,
                  stochastic=False, rng=None):
    """The quantize-dequantize round trip in ``x``'s dtype."""
    q, scale, zp = quantize(x, num_bits, num_groups, symmetric, stochastic,
                            rng)
    return dequantize(q, scale, zp, num_bits, dtype=x.dtype)


def quantize_weight_per_column(w: torch.Tensor, num_bits: int = 8
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int quantization of an ``[in, out]`` weight with one scale
    per output column (the layout :func:`int8_matmul` takes)."""
    assert w.dim() == 2, "per-column quantization expects a [in, out] matrix"
    qmax = _qmax(num_bits)
    w32 = w.float()
    scale = torch.clamp(_over(w32.abs().amax(dim=0), qmax), min=1e-12)
    q = torch.clamp(torch.round(w32 / scale[None, :]), -qmax - 1, qmax)
    return q.to(torch.int8 if num_bits <= 8 else torch.int32), scale


def quantize_weight_per_column_np(w, num_bits: int = 8):
    """The host (numpy) twin of :func:`quantize_weight_per_column`, also for
    a layer-stacked ``[L, in, out]`` weight (scales ``[L, out]``): numpy's
    division, as the JAX package's host function computes it."""
    w = np.asarray(w, np.float32)
    assert w.ndim in (2, 3), "expected [in, out] or [L, in, out]"
    qmax = _qmax(num_bits)
    axis = 0 if w.ndim == 2 else 1
    scale = np.maximum(np.abs(w).max(axis=axis) / qmax, 1e-12)
    sb = scale[None, :] if w.ndim == 2 else scale[:, None, :]
    q = np.clip(np.round(w / sb), -qmax - 1, qmax)
    return (q.astype(np.int8 if num_bits <= 8 else np.int32),
            scale.astype(np.float32))


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                preferred_dtype=torch.bfloat16) -> torch.Tensor:
    """``x`` times a per-column int8 weight: both cast to
    ``preferred_dtype``, the product accumulated in f32 (JAX's
    ``preferred_element_type``), scaled per column, then cast."""
    if not (w_scale.dim() == 1 and w_scale.shape[0] == w_q.shape[-1]):
        raise ValueError(
            "int8_matmul needs per-output-column scales: w_scale shape "
            f"{tuple(w_scale.shape)} does not match weight columns "
            f"{w_q.shape[-1]} (use quantize_weight_per_column)")
    y = torch.matmul(x.to(preferred_dtype).float(),
                     w_q.to(preferred_dtype).float())
    return (y * w_scale[None, :]).to(preferred_dtype)
