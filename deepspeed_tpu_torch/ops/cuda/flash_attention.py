"""Flash-attention forward on Hopper (counterpart of
``deepspeed_tpu/ops/pallas/flash_attention.py``: ``_fwd`` :114 and the public
``flash_attention`` :403).

``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu`` for CUDA
tensors (or raises) and computes ``flash_attention_reference``, the plain
PyTorch version of the same function, for CPU tensors. Layout is the model's
``[batch, seq, heads, head_dim]`` on both sides; lse comes back as
``[batch, heads, seq]`` f32.

The backward kernels and the ``torch.autograd.Function`` belong to the
training slice; until then an input that requires grad is refused.
"""

import ctypes
import functools
import math

import torch

from deepspeed_tpu_torch.ops.cuda.build import load_library
from deepspeed_tpu_torch.ops.cuda.common import NEG_INF

# head dims the kernel is instantiated for (csrc/flash_attention_fwd.cu)
HEAD_DIMS = (32, 64, 80, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches since the count was last set to 0 (CPU calls never count)
launches = 0


@functools.cache
def _kernel():
    fn = load_library("flash_attention_fwd").ds_flash_attention_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 6 + [i32] * 4 + [i64] * 9
                   + [ctypes.c_float, i32, i32, ptr])
    fn.restype = i32
    return fn


def _check(q, k, v, segment_ids):
    if q.dim() != 4:
        raise ValueError(f"q must be [batch, seq, heads, head_dim], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype or q.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"q, k, v must share one dtype of {list(_DTYPE_CODES)}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v are on different devices")
    b, t, _, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if t == 0:
        raise ValueError("empty sequence")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention has no backward yet (the dq/dkv kernels come "
            "with the training slice); call it under torch.no_grad()")
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, t):
            raise ValueError(
                f"segment_ids must be [batch, seq] = {(b, t)}, got "
                f"{tuple(segment_ids.shape)}")
        if segment_ids.device != q.device:
            raise ValueError("segment_ids is on another device than q")


def flash_attention_reference(q, k, v, *, causal=True, scale=None,
                              segment_ids=None):
    """Plain PyTorch version of the kernel: the full [T, T] score matrix in
    f32, the same finite NEG_INF masks, an f32 softmax. Returns
    ``(o [B, T, H, D] in q's dtype, lse [B, H, T] f32)``."""
    b, t, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf, kf, vf = (x.transpose(1, 2).float() for x in (q, k, v))  # [B, H, T, D]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    keep = torch.ones((t, t), dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None]
    if segment_ids is not None:
        keep = keep & (segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :])
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), vf)
    return o.transpose(1, 2).to(q.dtype), lse


def _launch(q, k, v, segment_ids, causal, scale):
    global launches
    elem = q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        # 16-byte vector loads along head_dim: rows must start 16-byte aligned
        if (x.stride(-1) != 1 or x.data_ptr() % 16
                or any(s * elem % 16 for s in x.stride()[:3])):
            raise ValueError(
                f"{name} must have a unit head_dim stride and 16-byte aligned "
                f"rows; got strides {x.stride()} at offset {x.data_ptr() % 16}")
    b, t, h, d = q.shape
    if b * h >= 2 ** 31 or t > 65535 * 16:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    seg = (segment_ids.to(torch.int32).contiguous()
           if segment_ids is not None else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg.data_ptr() if seg is not None else None,
            o.data_ptr(), lse.data_ptr(), b, t, h, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel failed: CUDA error {err}")
    launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal=True, scale=None, segment_ids=None):
    """Attention over ``[batch, seq, heads, head_dim]`` inputs. Returns
    ``(o, lse)``: o in q's dtype, lse ``[batch, heads, seq]`` f32.

    ``segment_ids`` (``[batch, seq]`` int, 0 = padding) restricts attention
    to same-segment keys (and, with ``causal``, earlier ones), as for
    packed-sequence batches. CUDA tensors run the kernel; CPU tensors run
    ``flash_attention_reference``."""
    _check(q, k, v, segment_ids)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         segment_ids=segment_ids)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return _launch(q, k, v, segment_ids, causal, scale)


def flash_attention(q, k, v, *, causal=True, scale=None, segment_ids=None):
    """``flash_attention_fwd`` without the lse: the signature of
    ``deepspeed_tpu.ops.pallas.flash_attention.flash_attention`` minus its
    TPU block-size arguments."""
    o, _ = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               segment_ids=segment_ids)
    return o
