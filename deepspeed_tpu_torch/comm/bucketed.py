"""Bucketed gradient exchange (counterpart of
``deepspeed_tpu/comm/bucketed.py``): the leaves of a gradient, in a fixed
order, packed into buckets of at most ``bucket_mb`` and exchanged one
collective per bucket, at the accumulation boundary.

* :func:`assign_buckets` / :func:`plan_for_tree`: the deterministic plan
  (greedy, leaves in order; a budget of 0 is one leaf per bucket). Every
  rank computes the same plan from the same sizes.
* :func:`bucketed_all_reduce`: the sum (or mean) per bucket at an f32 or
  bf16 wire. At f32 it is bit for bit the per-leaf exchange.
* :func:`bucketed_quantized_all_reduce`: the int8 exchange
  (``comm/compressed.py``) per bucket, with error feedback per bucket.
* :func:`hierarchy_groups` / :func:`hierarchical_all_reduce`: the two-level
  exchange over slices of the axis: a reduce-scatter at the wire dtype
  inside each slice, the int8 exchange of the shard across slices, an
  all-gather inside the slice; logged as ``level`` "ici" and "dcn". On
  cards a slice is a host (or ``dcn_slices`` of the config).

Here a "tree" is a list of tensors, the leaves in the exchange's order (the
engine passes the JAX flatten order, ``module_inject/jax_params.py``
``ExchangeLayout``). The functions return new tensors, as the JAX ones do;
with ``inplace=True`` leaves that lie end to end in one buffer (the
engine's f32 accumulators) are exchanged in that buffer, without the
concatenation's copy, and the results are views of it.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm.compressed import (quantized_all_reduce,
                                                 server_shard_length)
from deepspeed_tpu_torch.utils.logging import logger


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """``bucket_leaves[b]``: the leaf indices exchanged in bucket ``b``, in
    order; ``leaf_sizes``: every leaf's element count."""

    bucket_leaves: Tuple[Tuple[int, ...], ...]
    leaf_sizes: Tuple[int, ...]

    @property
    def num_buckets(self) -> int:
        return len(self.bucket_leaves)

    def bucket_sizes(self) -> Tuple[int, ...]:
        """Each bucket's element count."""
        return tuple(sum(self.leaf_sizes[i] for i in idxs)
                     for idxs in self.bucket_leaves)


def assign_buckets(leaf_sizes: Sequence[int], bucket_bytes: int,
                   itemsize: int = 4) -> BucketPlan:
    """Greedy packing in leaf order: a bucket closes when the next leaf
    would pass ``bucket_bytes``; a leaf larger than the budget has a bucket
    of its own; ``bucket_bytes <= 0`` is one leaf per bucket."""
    buckets, cur, cur_bytes = [], [], 0
    for i, n in enumerate(leaf_sizes):
        nbytes = int(n) * itemsize
        if cur and (bucket_bytes <= 0 or cur_bytes + nbytes > bucket_bytes):
            buckets.append(tuple(cur))
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
    if cur:
        buckets.append(tuple(cur))
    return BucketPlan(tuple(buckets), tuple(int(n) for n in leaf_sizes))


def _numel(leaf) -> int:
    if isinstance(leaf, int):
        return leaf
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
    n = 1
    for d in shape:
        n *= int(d)
    return n


def plan_for_tree(tree, bucket_mb: float, itemsize: int = 4) -> BucketPlan:
    """The plan for a list of leaves (tensors, shapes or element counts)
    at ``bucket_mb`` MiB per bucket."""
    sizes = [_numel(leaf) for leaf in tree]
    plan = assign_buckets(sizes, int(bucket_mb * 1024 * 1024), itemsize)
    logger.debug("bucket plan: %d buckets over %d leaves at %s MB, %d bytes",
                 plan.num_buckets, len(sizes), bucket_mb,
                 sum(sizes) * itemsize)
    return plan


def _adjacent(leaves, idxs) -> bool:
    """Whether the leaves lie end to end in one contiguous buffer."""
    first = leaves[idxs[0]]
    at = first.data_ptr()
    for i in idxs:
        leaf = leaves[i]
        if (not leaf.is_contiguous() or leaf.dtype != first.dtype
                or leaf.untyped_storage().data_ptr()
                != first.untyped_storage().data_ptr()
                or leaf.data_ptr() != at):
            return False
        at += leaf.numel() * leaf.element_size()
    return True


def _concat_bucket(leaves, idxs, dtype=None, inplace=False):
    """The bucket's payload: the leaves' elements end to end (in
    ``dtype``). ``inplace``: the buffer the leaves lie in, when they are
    adjacent and already of ``dtype``."""
    if inplace and (dtype is None or leaves[idxs[0]].dtype == dtype) \
            and _adjacent(leaves, idxs):
        total = sum(leaves[i].numel() for i in idxs)
        return leaves[idxs[0]].as_strided((total,), (1,))
    parts = [leaves[i].reshape(-1) if dtype is None
             else leaves[i].to(dtype).reshape(-1) for i in idxs]
    return parts[0].clone() if len(parts) == 1 else torch.cat(parts)


def _split_bucket(flat, leaves, idxs, out):
    off = 0
    for i in idxs:
        n = leaves[i].numel()
        out[i] = flat[off:off + n].view(leaves[i].shape).to(leaves[i].dtype)
        off += n


def _to_wire(flat, wire_dtype):
    return (flat if wire_dtype is None or flat.dtype == wire_dtype
            else flat.to(wire_dtype))


def bucketed_all_reduce(tree, axis, plan: Optional[BucketPlan] = None, *,
                        wire_dtype=None, mean: bool = False,
                        log_name: str = "bucketed_all_reduce",
                        inplace: bool = False):
    """The sum (or ``mean``) over ``axis`` of each leaf, one all-reduce per
    bucket (JAX :149). ``wire_dtype`` (``torch.bfloat16``) casts each
    bucket's payload for the wire and back. Each bucket is logged as
    ``<log_name>.bucket<i>``; ``plan=None`` is one bucket per leaf."""
    leaves = list(tree)
    if plan is None:
        plan = assign_buckets([l.numel() for l in leaves], 0)
    w = comm.comm._world_of(axis)
    out = [None] * len(leaves)
    for b, idxs in enumerate(plan.bucket_leaves):
        flat = _concat_bucket(leaves, idxs, inplace=inplace)
        payload = _to_wire(flat, wire_dtype)
        comm.all_reduce(payload, axis, log_name=f"{log_name}.bucket{b}")
        if payload is not flat:
            flat.copy_(payload)
        if mean:
            flat.div_(w)
        _split_bucket(flat, leaves, idxs, out)
    return out


def hierarchy_groups(world: int, num_slices: int):
    """``(ici, dcn)`` index groups of an axis of ``world`` ranks over
    ``num_slices`` slices, the slice the slow dimension: rank = slice *
    per_slice + position. ICI groups are each slice's ranks, DCN groups the
    ranks at one position in every slice."""
    if num_slices < 1 or world % num_slices:
        raise ValueError(
            f"cannot split a dp axis of {world} ranks into {num_slices} "
            f"equal slices")
    per = world // num_slices
    ici = tuple(tuple(s * per + i for i in range(per))
                for s in range(num_slices))
    dcn = tuple(tuple(s * per + i for s in range(num_slices))
                for i in range(per))
    return ici, dcn


def hierarchical_all_reduce(tree, axis: str, num_slices: int,
                            plan: Optional[BucketPlan] = None, *,
                            block: int = 512, wire_dtype=torch.bfloat16,
                            mean: bool = False,
                            log_name: str = "hierarchical_grad_exchange",
                            inplace: bool = False):
    """The two-level sum (or ``mean``) of each leaf (JAX :205), per
    bucket: a reduce-scatter at ``wire_dtype`` within each slice (logged
    "ici"), the int8 :func:`quantized_all_reduce` of the shard across
    slices (``dcn``, no error feedback), an all-gather at ``wire_dtype``
    within the slice. ``num_slices=1`` is a scatter and a gather with no
    DCN leg."""
    leaves = list(tree)
    if plan is None:
        plan = assign_buckets([l.numel() for l in leaves], 0)
    w = comm.comm._world_of(axis)
    ici, dcn = hierarchy_groups(w, num_slices)
    per_slice = w // num_slices
    out = [None] * len(leaves)
    for b, idxs in enumerate(plan.bucket_leaves):
        flat = _concat_bucket(leaves, idxs, inplace=inplace)
        n = flat.numel()
        pad = (-n) % per_slice
        padded = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat
        name = f"{log_name}.bucket{b}"
        shard = comm.reduce_scatter(
            _to_wire(padded, wire_dtype), axis, axis_index_groups=ici,
            log_name=f"{name}.ici", level="ici").to(flat.dtype)
        if num_slices > 1:
            shard = quantized_all_reduce(
                shard, axis, block=block, axis_index_groups=dcn,
                log_name=f"{name}.dcn", level="dcn")
        full = comm.all_gather(
            _to_wire(shard, wire_dtype), axis, axis_index_groups=ici,
            log_name=f"{name}.ici", level="ici")
        flat.copy_(full[:n])
        if mean:
            flat.div_(w)
        _split_bucket(flat, leaves, idxs, out)
    return out


def bucketed_quantized_all_reduce(
        tree, axis, plan: Optional[BucketPlan] = None, *, block: int = 512,
        worker_errors: Optional[Sequence[torch.Tensor]] = None,
        server_errors: Optional[Sequence[torch.Tensor]] = None,
        log_name: str = "quantized_all_reduce", inplace: bool = False):
    """The int8 exchange per bucket with error feedback per bucket (JAX
    :272): ``worker_errors[b]`` (``[bucket_len]`` f32) is added to bucket
    b's payload, ``server_errors[b]`` (``[server_shard_length(bucket_len,
    w, block)]``) compensates its phase 2; either may be None (a cold
    start). Returns ``(sums, new_worker_errors, new_server_errors)``: the
    SUM of each leaf over the axis, the residuals as per-bucket tuples.
    Logged as ``<log_name>.bucket<i>`` and ``...bucket<i>.scales``."""
    leaves = list(tree)
    if plan is None:
        plan = assign_buckets([l.numel() for l in leaves], 0)
    w = comm.comm._world_of(axis)
    out = [None] * len(leaves)
    new_we, new_se = [], []
    for b, idxs in enumerate(plan.bucket_leaves):
        flat = _concat_bucket(leaves, idxs, dtype=torch.float32,
                              inplace=inplace)
        payload = flat if worker_errors is None else flat + worker_errors[b]
        se = (server_errors[b] if server_errors is not None
              else flat.new_zeros(server_shard_length(flat.numel(), w,
                                                      block)))
        reduced, err, new_server = quantized_all_reduce(
            payload, axis, block=block, return_error=True, server_error=se,
            log_name=f"{log_name}.bucket{b}")
        flat.copy_(reduced)
        _split_bucket(flat, leaves, idxs, out)
        new_we.append(err)
        new_se.append(new_server)
    return out, tuple(new_we), tuple(new_se)
