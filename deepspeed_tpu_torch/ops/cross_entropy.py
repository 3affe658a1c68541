"""Softmax cross entropy over compute-dtype logits (counterpart of
``deepspeed_tpu/ops/cross_entropy.py``: ``_ce_fwd_math`` :28 and the custom
VJP ``softmax_cross_entropy`` :45-76).

Plain PyTorch: the JAX side has no kernel here either (XLA fuses it). The
forward reduces in f32 and gathers the target logit from the original dtype;
the backward emits ``scale * (softmax - onehot)`` in the LOGITS' dtype, so the
two vocabulary-sized matmuls behind it stay in bf16. The vocabulary-chunked
``fused_linear_cross_entropy`` (:100) is not ported.
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
