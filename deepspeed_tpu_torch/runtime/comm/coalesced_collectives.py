"""Coalesced collectives (counterpart of
``deepspeed_tpu/runtime/comm/coalesced_collectives.py``): many tensors of
ragged sizes reduced or gathered in ONE collective, by packing them end to
end into a flat buffer padded to a multiple of the axis size. Nothing in
the engine calls them (its ZeRO buffers are flat already,
``runtime/zero/sharding.py``); they are here for the API.
"""

from typing import List, Sequence, Tuple

import torch

from deepspeed_tpu_torch import comm


def _flatten_pad(tensors: Sequence[torch.Tensor], world: int):
    """The tensors raveled end to end, zero-padded to a multiple of
    ``world``; and each one's ``(numel, shape, dtype)``."""
    meta = [(t.numel(), tuple(t.shape), t.dtype) for t in tensors]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    pad = (-flat.numel()) % world
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, meta


def reduce_scatter_coalesced(tensors: Sequence[torch.Tensor], axis
                             ) -> torch.Tensor:
    """The sum over ``axis`` of the packed tensors, this rank's flat shard
    of it (JAX :47); :func:`shard_layout` locates each tensor in it."""
    world = comm.comm._world_of(axis)
    flat, _ = _flatten_pad(tensors, world)
    return comm.reduce_scatter(flat, axis)


def all_gather_coalesced(shards: Sequence[torch.Tensor], axis
                         ) -> List[torch.Tensor]:
    """Each full flat tensor from every rank's equal-size shard of it, in
    one all-gather (JAX :62): ``out[i]`` has ``world * shards[i].numel()``
    elements, rank-major."""
    world = comm.comm._world_of(axis)
    sizes = [s.numel() for s in shards]
    flat = torch.cat([s.reshape(-1) for s in shards])
    packs = comm.all_gather(flat, axis).view(world, flat.numel())
    out, offset = [], 0
    for n, s in zip(sizes, shards):
        out.append(packs[:, offset:offset + n].reshape(world * n).to(s.dtype))
        offset += n
    return out


def shard_layout(tensors: Sequence, world: int) -> List[Tuple[int, int]]:
    """``(start, length)`` of each tensor (or element count) in the packed
    buffer (JAX :86)."""
    spans, offset = [], 0
    for t in tensors:
        n = t.numel() if hasattr(t, "numel") else int(t)
        spans.append((offset, n))
        offset += n
    return spans
