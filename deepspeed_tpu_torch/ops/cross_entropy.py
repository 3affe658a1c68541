"""Softmax cross entropy over compute-dtype logits (counterpart of
``deepspeed_tpu/ops/cross_entropy.py``: ``_ce_fwd_math`` :28 and the custom
VJP ``softmax_cross_entropy`` :45-76).

Plain PyTorch: the JAX side has no kernel here either (XLA fuses it). The
forward reduces in f32 and gathers the target logit from the original dtype;
the backward emits ``scale * (softmax - onehot)`` in the LOGITS' dtype, so the
two vocabulary-sized matmuls behind it stay in bf16.

``fused_linear_cross_entropy`` (:82-199) fuses the LM head into the loss:
the ``[N, V]`` logits exist one token chunk at a time, in the forward and
again in the backward, which recomputes them. Its products are plain
matmuls (cuBLAS), as in JAX, where they run outside any Pallas kernel.
"""

import torch


def _ce_fwd_math(logits, targets):
    """Per-token nll and logsumexp (f32, [N]) of [N, V] logits."""
    lf = logits.float()
    m = lf.max(dim=-1, keepdim=True).values
    lse = torch.log(torch.exp(lf - m).sum(dim=-1)) + m[..., 0]
    tgt = logits.gather(-1, targets[..., None])[..., 0].float()
    return lse - tgt, lse


class SoftmaxCrossEntropy(torch.autograd.Function):
    """Weighted mean nll: logits [N, V] (compute dtype), targets [N] int,
    weights [N] f32; the mean is over ``max(sum(weights), 1)``."""

    @staticmethod
    def forward(ctx, logits, targets, weights):
        nll, lse = _ce_fwd_math(logits, targets)
        denom = torch.clamp(weights.sum(), min=1.0)
        ctx.save_for_backward(logits, targets, weights, lse, denom)
        return (nll * weights).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, targets, weights, lse, denom = ctx.saved_tensors
        scale = (g * weights / denom).float()[:, None]
        p = torch.exp(logits.float() - lse[:, None])
        # p - onehot, in place: only the target column changes
        rows = torch.arange(p.shape[0], device=p.device)
        p[rows, targets] -= 1.0
        return (p.mul_(scale)).to(logits.dtype), None, None


def softmax_cross_entropy(logits, targets, weights):
    return SoftmaxCrossEntropy.apply(logits, targets, weights)


# ---------------------------------------------------------------------------
# Fused LM head + cross entropy (the [N, V] logits never materialize)
# ---------------------------------------------------------------------------
def _head_logits(x_c, w, bias, vocab_major):
    """``[n, E] -> [n, V]`` logits in the compute dtype (``w`` is ``[V, E]``
    when ``vocab_major``, the tied embedding's layout, else ``[E, V]``); the
    bias is added after the product, cast to the logits' dtype."""
    logits = torch.nn.functional.linear(x_c, w if vocab_major else w.t())
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    return logits


def _mm_f32(a, b):
    """``a @ b`` accumulated and returned in f32 (``preferred_element_type=
    f32``): cuBLAS with an f32 output on the card; the CPU multiplies the
    upcast operands, which hold the same values."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class FusedLinearCrossEntropy(torch.autograd.Function):
    """The weighted mean nll of ``softmax(x @ w + bias)`` over token chunks
    (``_flce``): ``x`` [N, E] (N a multiple of ``chunk``), targets [N],
    weights [N] f32. The forward keeps x, w, bias, the targets, the weights
    and the per-token lse; the backward recomputes each chunk's logits and
    forms ``dl = (p - onehot) * w * g / denom`` in the compute dtype, dx per
    chunk and dw (and db) summed in f32."""

    @staticmethod
    def forward(ctx, vocab_major, chunk, x, w, bias, targets, weights):
        n = x.shape[0]
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lse = torch.empty(n, dtype=torch.float32, device=x.device)
        for start in range(0, n, chunk):
            sl = slice(start, start + chunk)
            nll, lse_c = _ce_fwd_math(_head_logits(x[sl], w, bias,
                                                   vocab_major), targets[sl])
            total = total + (nll * weights[sl]).sum()
            lse[sl] = lse_c
        denom = torch.clamp(weights.sum(), min=1.0)
        ctx.save_for_backward(x, w, bias, targets, weights, lse, denom)
        ctx.vocab_major, ctx.chunk = vocab_major, chunk
        return total / denom

    @staticmethod
    def backward(ctx, g):
        x, w, bias, targets, weights, lse, denom = ctx.saved_tensors
        vocab_major, chunk = ctx.vocab_major, ctx.chunk
        gscale = g.float() / denom
        dx = torch.empty_like(x)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        db = (None if bias is None else
              torch.zeros(bias.shape, dtype=torch.float32, device=w.device))
        rows = torch.arange(min(chunk, x.shape[0]), device=x.device)
        for start in range(0, x.shape[0], chunk):
            sl = slice(start, start + chunk)
            x_c = x[sl]
            p = torch.exp(_head_logits(x_c, w, bias, vocab_major).float()
                          - lse[sl, None])
            p[rows, targets[sl]] -= 1.0                       # p - onehot
            dl = p.mul_((weights[sl] * gscale)[:, None]).to(x.dtype)
            if vocab_major:
                # dl [n, V], w [V, E]: dx = dl w, dw [V, E] = dl^T x
                dx[sl] = dl @ w
                dw += _mm_f32(dl.t(), x_c)
            else:
                # dl [n, V], w [E, V]: dx = dl w^T, dw [E, V] = x^T dl
                dx[sl] = dl @ w.t()
                dw += _mm_f32(x_c.t(), dl)
            if db is not None:
                db += dl.float().sum(dim=0)
        return (None, None, dx, dw.to(w.dtype),
                None if bias is None else db.to(bias.dtype), None, None)


def fused_linear_cross_entropy(vocab_major, chunk, x, w, bias, targets,
                               weights):
    """Weighted-mean nll of ``softmax(x @ w + bias)`` without the [N, V]
    logits. x: [N, E] compute dtype; w: [E, V] ([V, E] when ``vocab_major``);
    targets: [N] int; weights: [N] f32. N is padded up to a multiple of the
    chunk (target 0, weight 0)."""
    n = x.shape[0]
    c = min(max(1, chunk), n)
    pad = (-n) % c
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
    return FusedLinearCrossEntropy.apply(vocab_major, c, x, w, bias,
                                         targets, weights)
