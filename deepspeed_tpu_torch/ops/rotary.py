"""Rotary position embeddings (counterpart of ``deepspeed_tpu/ops/rotary.py``).

Plain PyTorch, as the JAX side is plain ``jnp`` that XLA fuses into the
attention's matmuls: no kernel computes it there either. The order of
operations is the JAX one, so that both packages round alike: the inverse
frequencies and the angles in f32, ``cos`` and ``sin`` cast to ``x``'s dtype
before they multiply (under bf16 the rotation is a bf16 product), the
half split of GPT-NeoX/LLaMA or the even/odd pairs of GPT-J, and the
dimensions past ``rotary_dim`` passed through unchanged.
"""

from typing import Optional, Tuple

import torch


def rotary_angles(positions: torch.Tensor, dim: int, base: float = 10000.0,
                  dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape ``[..., dim / 2]`` for integer positions."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=positions.device) / dim
    inv_freq = 1.0 / (base ** exponent)
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rotary_pos_emb(x: torch.Tensor,
                         positions: Optional[torch.Tensor] = None,
                         base: float = 10000.0,
                         rotary_dim: Optional[int] = None,
                         interleaved: bool = False) -> torch.Tensor:
    """Rotate ``x`` (``[batch, seq, heads, head_dim]``) by the angles of
    ``positions`` (``[batch or 1, seq]``; default ``arange(seq)``).

    ``interleaved=False`` rotates the pairs (i, i + rotary_dim / 2), the
    GPT-NeoX/LLaMA convention; ``interleaved=True`` the pairs (2i, 2i + 1),
    GPT-J's. Returns a new tensor in ``x``'s dtype."""
    _, t, _, d = x.shape
    rd = rotary_dim or d
    if positions is None:
        positions = torch.arange(t, device=x.device)[None, :]
    cos, sin = rotary_angles(positions, rd, base, dtype=x.dtype)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]  # [b, t, 1, rd/2]

    x_rot, x_pass = x[..., :rd], x[..., rd:]
    if interleaved:
        x1, x2 = x_rot[..., ::2], x_rot[..., 1::2]
        rotated = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                              dim=-1).reshape(x_rot.shape)
    else:
        x1, x2 = x_rot[..., :rd // 2], x_rot[..., rd // 2:]
        rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                            dim=-1)
    if rd < d:
        return torch.cat([rotated, x_pass], dim=-1)
    return rotated
