"""Chunked (online-softmax) attention (counterpart of
``deepspeed_tpu/ops/chunked_attention.py``).

Plain PyTorch, as the JAX version is plain XLA: a loop over KV chunks
carrying the online-softmax state (running max m, normalizer l and the
weighted sum acc, all f32), so the scores live as ``[B, H, T, chunk]`` per
step instead of ``[B, H, T, T]``. Each chunk's body runs under
``torch.utils.checkpoint`` (JAX's ``jax.checkpoint(body)`` in the scan):
the backward recomputes each chunk's scores from the carry instead of
keeping them. The products take compute-dtype operands with f32 results
(``preferred_element_type=f32``); the result matches the einsum path to the
compute dtype's rounding.
"""

import math

import torch
import torch.utils.checkpoint


class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of 16-bit CUDA tensors with f32 accumulation and result
    (cuBLAS with an f32 output, which has no autograd formula of its own).
    The backward takes the cotangent in the operands' dtype, products
    accumulated in f32 and returned in that dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _bmm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        return (_bmm_f32(g, b.transpose(-1, -2)).to(a.dtype),
                _bmm_f32(a.transpose(-1, -2), g).to(b.dtype))


def _bmm_f32(a, b):
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.view(*lead, a.shape[-2], b.shape[-1])


def _matmul_f32(a, b):
    """``a @ b`` over ``[..., m, k] x [..., k, n]`` with f32 results: a
    16-bit product on the card accumulates and returns f32
    (``_MatmulF32``); the CPU, which has no such product, multiplies the
    upcast operands, which hold the same values."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    return _MatmulF32.apply(a, b)


def _chunk_body(m, l, acc, qh, kh, vh, start: int, chunk: int, causal: bool,
                scale: float):
    """One KV chunk folded into the carry (the scan body)."""
    k_c = kh[:, :, start:start + chunk]
    v_c = vh[:, :, start:start + chunk]
    s = _matmul_f32(qh, k_c.transpose(-1, -2)) * scale        # [B,H,T,c]
    if causal:
        t = qh.shape[2]
        q_pos = torch.arange(t, device=qh.device)
        k_pos = start + torch.arange(chunk, device=qh.device)
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                        torch.finfo(torch.float32).min)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # exp(min - m_new) underflows to exactly 0: a fully masked row adds
    # nothing, and l stays 0 until a visible chunk arrives
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + _matmul_f32(p.to(qh.dtype), v_c)
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, causal: bool = True, chunk: int = 1024):
    """Attention over ``[B, T, H, D]`` tensors with bounded score memory.
    ``T`` must be divisible by ``chunk`` (the callers gate on it, as the
    flash path gates on 128-alignment). Returns ``[B, T, H, D]`` in q's
    dtype."""
    b, t, h, d = q.shape
    if t % chunk:
        raise ValueError(f"seq len {t} not divisible by chunk {chunk}")
    scale = 1.0 / math.sqrt(d)
    # [B, H, T, D] views: the per-chunk products batch over (B, H)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    m = torch.full((b, h, t), torch.finfo(torch.float32).min,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=q.device)
    for start in range(0, t, chunk):
        m, l, acc = torch.utils.checkpoint.checkpoint(
            _chunk_body, m, l, acc, qh, kh, vh, start, chunk, causal, scale,
            use_reentrant=False, preserve_rng_state=False)
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.to(q.dtype).transpose(1, 2)
