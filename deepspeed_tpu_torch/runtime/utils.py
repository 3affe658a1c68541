"""Gradient-norm helpers and the overflow check (counterpart of
``deepspeed_tpu/runtime/utils.py:23-71``), over lists of tensors. The
norm is taken in f32 over all gradients; clipping scales in place.

Under ZeRO a rank holds a shard of the gradient: with ``axis`` (the mesh
axis the shards lie over) the norm is the local one combined by one
all-reduce (of the sum of ``|g|^p``, or of the max for the inf-norm), and
the engine all-reduces the overflow flag, so every rank clips by the same
global norm and skips the same steps."""

from typing import Optional, Sequence, Union

import torch

from deepspeed_tpu_torch.runtime.loss_scaler import has_overflow


def get_global_norm(tensors: Sequence[torch.Tensor], norm_type: float = 2.0,
                    axis: Optional[str] = None) -> torch.Tensor:
    """The f32 ``norm_type``-norm over every element of ``tensors`` (a
    0-dim device tensor), and over every rank's ``tensors`` on ``axis``
    when given (a collective)."""
    from deepspeed_tpu_torch import comm

    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.tensor(0.0)
    if norm_type == float("inf"):
        norm = torch.stack([t.abs().max().float() for t in tensors]).max()
        if axis is not None:
            comm.all_reduce(norm, axis, comm.ReduceOp.MAX)
        return norm
    # accumulates in f32 whatever the tensors' dtype, without an f32 copy
    norms = torch._foreach_norm(tensors, norm_type, dtype=torch.float32)
    norm = torch.linalg.vector_norm(torch.stack(norms), norm_type)
    if axis is None:
        return norm
    return comm.all_reduce(norm ** norm_type, axis) ** (1.0 / norm_type)


def clip_factor(norm: torch.Tensor,
                max_norm: Union[float, torch.Tensor]) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-6))`` in f32, on the norm's device.

    ``max_norm`` is best an f32 tensor on that device, made once: from a
    float this makes one (a host-to-device copy, which a captured step
    cannot hold). Not ``max_norm / t`` with a float: PyTorch computes a
    float over a tensor as the tensor's reciprocal times the float, which
    rounds differently from the JAX step's ``clip / (norm + 1e-6)``."""
    if not torch.is_tensor(max_norm):
        max_norm = norm.new_tensor(max_norm)
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_grad_norm_(grads: Sequence[torch.Tensor],
                    max_norm: Union[float, torch.Tensor],
                    norm_type: float = 2.0,
                    axis: Optional[str] = None) -> torch.Tensor:
    """Scale ``grads`` in place so their global norm (over ``axis`` too,
    when given) is at most ``max_norm`` (a float, or an f32 tensor on the
    grads' device); returns the norm before clipping."""
    grads = [g for g in grads if g is not None]
    norm = get_global_norm(grads, norm_type, axis)
    if grads:
        # an f32 factor: each grad is scaled in f32 and rounded once
        torch._foreach_mul_(grads, clip_factor(norm, max_norm))
    return norm



class CheckOverflow:
    """Inf/NaN detection over a list of gradients (the reference's
    ``CheckOverflow``; under ZeRO the engine all-reduces the flag of each
    rank's shard, ``ZeroOptimizer.overflow``). The flag stays on the
    device, so a captured step may compute it."""

    def __init__(self, param_groups=None, mpu=None, zero_reduce_scatter=False):
        del param_groups, mpu, zero_reduce_scatter

    @staticmethod
    def has_overflow(grads: Sequence[torch.Tensor]) -> torch.Tensor:
        return has_overflow([g for g in grads if g is not None])

    __call__ = staticmethod(has_overflow)
