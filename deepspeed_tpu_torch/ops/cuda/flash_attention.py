"""Flash attention on Hopper, forward and backward (counterpart of
``deepspeed_tpu/ops/pallas/flash_attention.py``: ``_fwd`` :114,
``_bwd_impl`` :267, the custom VJPs ``_flash``/``_flash_seg`` :354-400 and
the public ``flash_attention`` :403).

``flash_attention_fwd`` launches ``csrc/flash_attention_fwd.cu`` (B1) and
``flash_attention_bwd`` the two kernels of ``csrc/flash_attention_bwd.cu``
(B2: dq, B3: dk and dv) for CUDA tensors, or raises. With 16-bit inputs at
head dims 64 and 128 all three are Hopper kernels (wgmma, TMA loads, a
producer warp and two consumer warpgroups); at 32, 80 and 96 they are the
``mma.sync`` kernels, in f32 FMA kernels; the ``.cu`` entry points choose,
and a refused launch raises. For CPU tensors they
compute ``flash_attention_reference`` and ``flash_attention_backward_reference``,
the plain PyTorch versions of the same functions. ``flash_attention`` ties
them together in ``FlashAttentionFunction``, whose forward saves q, k, v, o
and lse. Layout is the model's ``[batch, seq, heads, head_dim]`` on both
sides; lse comes back as ``[batch, heads, seq]`` f32.

The forward reaches the dispatcher as one op, ``deepspeed_tpu_torch::
flash_fwd`` (o and lse), whose outputs carry the checkpoint names
``attn_out`` and ``attn_lse`` (the JAX kernel's ``checkpoint_name`` tags):
a selective recomputation policy sees B1 there and can keep its outputs
instead of launching it again (``runtime/activation_checkpointing``).
"""

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.cuda.build import load_library
from deepspeed_tpu_torch.ops.cuda.common import NEG_INF, check_current_device
from deepspeed_tpu_torch.runtime.activation_checkpointing.checkpointing \
    import name_op_outputs

# head dims the kernel is instantiated for (csrc/flash_attention_fwd.cu)
HEAD_DIMS = (32, 64, 80, 96, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# kernel launches since the counts were last set to 0 (CPU calls never
# count): B1 (forward), B2 (dq) and B3 (dk, dv); the ``_segment`` counts
# are the launches among them that took the segment variant (packed
# batches: a segment-id pointer, the same-segment mask)
launches = 0
launches_dq = 0
launches_dkv = 0
launches_segment = 0
launches_dq_segment = 0
launches_dkv_segment = 0


@functools.cache
def _kernel():
    fn = load_library("flash_attention_fwd").ds_flash_attention_fwd
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([ptr] * 6 + [i32] * 4 + [i64] * 9
                   + [ctypes.c_float, i32, i32, ptr])
    fn.restype = i32
    return fn


@functools.cache
def _bwd_kernels():
    lib = load_library("flash_attention_bwd")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tail = [i32] * 4 + [ptr, f32, i32, i32, ptr]  # B,T,H,D, strides, ...
    dq, dkv = lib.ds_flash_attention_bwd_dq, lib.ds_flash_attention_bwd_dkv
    dq.argtypes = [ptr] * 8 + tail
    dkv.argtypes = [ptr] * 9 + tail
    dq.restype = dkv.restype = i32
    return dq, dkv


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
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (b, t):
            raise ValueError(
                f"segment_ids must be [batch, seq] = {(b, t)}, got "
                f"{tuple(segment_ids.shape)}")
        if segment_ids.device != q.device:
            raise ValueError("segment_ids is on another device than q")


def _keep_mask(t, causal, segment_ids, device):
    """[1 or B, 1, T, T] bool: which (query, key) pairs are visible."""
    keep = torch.ones((t, t), dtype=torch.bool, device=device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None]
    if segment_ids is not None:
        keep = keep & (segment_ids[:, None, :, None]
                       == segment_ids[:, None, None, :])
    return keep


def _scores(q, k, causal, scale, segment_ids):
    """f32 [B, H, T, T] scaled scores with NEG_INF at masked pairs, and the
    f32 [B, H, T, D] views of q and k they came from."""
    qf, kf = (x.transpose(1, 2).float() for x in (q, k))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    keep = _keep_mask(q.shape[1], causal, segment_ids, q.device)
    return torch.where(keep, s, torch.full_like(s, NEG_INF)), qf, kf


def flash_attention_reference(q, k, v, *, causal=True, scale=None,
                              segment_ids=None):
    """Plain PyTorch version of the kernel: the full [T, T] score matrix in
    f32, the same finite NEG_INF masks, an f32 softmax. Returns
    ``(o [B, T, H, D] in q's dtype, lse [B, H, T] f32)``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s, _, _ = _scores(q, k, causal, scale, segment_ids)
    lse = torch.logsumexp(s, dim=-1)
    o = torch.matmul(torch.exp(s - lse[..., None]), v.transpose(1, 2).float())
    return o.transpose(1, 2).to(q.dtype), lse


def flash_attention_backward_reference(q, k, v, o, lse, do, *, causal=True,
                                       scale=None, segment_ids=None):
    """Plain PyTorch version of the backward kernels: P recomputed from the
    saved lse over the full [T, T] matrix with the forward's masks, then
    ``delta = rowsum(o * do)``, ``dS = P * (do v^T - delta)``,
    ``dq = scale dS k``, ``dk = scale dS^T q`` and ``dv = P^T do``, all in
    f32. Returns ``(dq, dk, dv)`` ``[B, T, H, D]`` in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s, qf, kf = _scores(q, k, causal, scale, segment_ids)
    vf, of, dof = (x.transpose(1, 2).float() for x in (v, o, do))
    p = torch.exp(s - lse[..., None])
    delta = (of * dof).sum(-1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return tuple(x.transpose(1, 2).to(q.dtype) for x in (dq, dk, dv))


def _check_launch(q, k, v):
    elem = q.element_size()
    for name, x in (("q", q), ("k", k), ("v", v)):
        # 16-byte vector loads along head_dim: rows must start 16-byte aligned
        if (x.stride(-1) != 1 or x.data_ptr() % 16
                or any(s * elem % 16 for s in x.stride()[:3])):
            raise ValueError(
                f"{name} must have a unit head_dim stride and 16-byte aligned "
                f"rows; got strides {x.stride()} at offset {x.data_ptr() % 16}")
    b, t, h, _ = q.shape
    if b * h >= 2 ** 31 or t > 65535 * 16:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernel's grid")


def _seg_i32(segment_ids):
    return (segment_ids.to(torch.int32).contiguous()
            if segment_ids is not None else None)


def _launch(q, k, v, segment_ids, causal, scale):
    global launches, launches_segment
    _check_launch(q, k, v)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    seg = _seg_i32(segment_ids)
    check_current_device(q)
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
    launches_segment += seg is not None
    return o, lse


def _bwd_call(fn, q, k, v, lse, delta, do, segment_ids, causal, scale, outs):
    """One backward kernel: ``fn`` is B2 (outs = (dq,)) or B3 (dk, dv)."""
    b, t, h, d = q.shape
    seg = _seg_i32(segment_ids)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    check_current_device(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  seg.data_ptr() if seg is not None else None, do.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(),
                  *(x.data_ptr() for x in outs), b, t, h, d,
                  ctypes.cast(strides, ctypes.c_void_p), float(scale),
                  int(bool(causal)), _DTYPE_CODES[q.dtype], stream)


def _launch_dq(q, k, v, lse, delta, do, segment_ids, causal, scale):
    """B2 alone, from a precomputed ``delta`` [B, H, T] f32."""
    global launches_dq, launches_dq_segment
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _bwd_call(_bwd_kernels()[0], q, k, v, lse, delta, do, segment_ids,
                    causal, scale, (dq,))
    if err:
        raise RuntimeError(f"flash_attention_bwd dq kernel failed: CUDA error {err}")
    launches_dq += 1
    launches_dq_segment += segment_ids is not None
    return dq


def _launch_dkv(q, k, v, lse, delta, do, segment_ids, causal, scale):
    """B3 alone, from a precomputed ``delta`` [B, H, T] f32."""
    global launches_dkv, launches_dkv_segment
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    err = _bwd_call(_bwd_kernels()[1], q, k, v, lse, delta, do, segment_ids,
                    causal, scale, (dk, dv))
    if err:
        raise RuntimeError(f"flash_attention_bwd dkv kernel failed: CUDA error {err}")
    launches_dkv += 1
    launches_dkv_segment += segment_ids is not None
    return dk, dv


def bwd_delta(o, do):
    """delta = rowsum(o * do) in f32, [B, H, T]: the ``_bwd_impl`` prologue
    (:277), plain PyTorch before the two kernels."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd(q, k, v, o, lse, do, segment_ids, causal, scale):
    _check_launch(q, k, v)
    delta = bwd_delta(o, do)
    args = (q, k, v, lse, delta, do, segment_ids, causal, scale)
    return (_launch_dq(*args), *_launch_dkv(*args))


def _on_device(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return q.device.type == "cuda"


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
    if not _on_device(q):
        return flash_attention_reference(q, k, v, causal=causal, scale=scale,
                                         segment_ids=segment_ids)
    return _launch(q, k, v, segment_ids, causal, scale)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, scale=None,
                        segment_ids=None):
    """Gradients ``(dq, dk, dv)`` ``[batch, seq, heads, head_dim]`` in q's
    dtype, from the forward's inputs, its output ``o``, its ``lse`` and the
    output's gradient ``do``. CUDA tensors run the B2 (dq) and B3 (dk, dv)
    kernels; CPU tensors run ``flash_attention_backward_reference``."""
    _check(q, k, v, segment_ids)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"o {tuple(o.shape)} and do {tuple(do.shape)} must have q's shape "
            f"{tuple(q.shape)}")
    b, t, h, _ = q.shape
    if tuple(lse.shape) != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 [batch, heads, seq] = {(b, h, t)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    # autograd hands over do in whatever layout the consumer produced
    do = do.to(q.dtype).contiguous()
    if not _on_device(q):
        return flash_attention_backward_reference(
            q, k, v, o, lse, do, causal=causal, scale=scale,
            segment_ids=segment_ids)
    return _launch_bwd(q, k, v, o.contiguous(), lse.contiguous(), do,
                       segment_ids, causal, scale)


@torch.library.custom_op("deepspeed_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 segment_ids: Optional[torch.Tensor], causal: bool,
                 scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as one dispatcher op (B1, or its plain
    version on CPU tensors): what a selective checkpoint policy sees."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                               segment_ids=segment_ids)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, segment_ids, causal, scale):
    b, t, h, d = q.shape
    return (q.new_empty((b, t, h, d)),
            q.new_empty((b, h, t), dtype=torch.float32))


name_op_outputs("deepspeed_tpu_torch::flash_fwd", "attn_out", "attn_lse")


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient (the ``_flash``/``_flash_seg``
    custom VJPs): the forward runs B1 (``flash_fwd_op``) and saves q, k, v,
    o and lse; the backward runs B2 and B3. ``segment_ids`` gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale):
        o, lse = flash_fwd_op(q, k, v, segment_ids, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, o, lse, do, causal=ctx.causal, scale=ctx.scale,
            segment_ids=segment_ids)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal=True, scale=None, segment_ids=None):
    """Differentiable flash attention: the signature of
    ``deepspeed_tpu.ops.pallas.flash_attention.flash_attention`` minus its
    TPU block-size arguments."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttentionFunction.apply(q, k, v, segment_ids, causal,
                                        float(scale))
