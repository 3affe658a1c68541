"""ZeRO stages as partition rules over flat buffers (counterpart of
``deepspeed_tpu/runtime/zero/sharding.py``: ``ZeroShardingRules`` :63 with
``param_spec`` :124, ``grad_accum_spec`` :132 and ``opt_state_spec``
:138).

The rules are the JAX package's: stage 1 partitions the optimizer state
over the ``fsdp`` axis, stage 2 also the f32 gradient-accumulation
buffers, stage 3 also every parameter of at least
``param_persistence_threshold`` elements (the config's
``stage3_param_persistence_threshold``); smaller leaves stay whole on
every rank, their gradients and optimizer state partitioned as at stage 2.

**The layout differs from the JAX package's.** JAX shards the largest
dimension of each leaf that the axis divides (``shard_largest_dim_spec``)
and lets XLA place the collectives. The port partitions as the reference
DeepSpeed does (``stage_1_and_2.py``): ``FlatPartition`` lays the
parameters of each dtype end to end in ONE contiguous buffer (each leaf at
a multiple of ``ALIGN`` elements), padded to a multiple of ``world x
ALIGN`` elements, and rank r of the axis owns the elements ``[r n / w,
(r + 1) n / w)``; the parameters become views of the buffer. At stage 3
the same layout holds each unit's partitioned parameters
(``runtime/zero/stage3.py``: a transformer block, or the embeddings and
final norm), and a rank keeps only its shard of each unit's buffer. A
rank's optimizer state is then one tensor per dtype (at stage 3, per unit
and dtype), so the update (B4) is one launch over the rank's shards and
each collective is one call on one flat buffer; sharding each leaf instead would give B4 strided slices and a
collective per leaf. A leaf may straddle two ranks' shards (LAMB's per-leaf
trust ratio sums its pieces: ``runtime/optimizer.py``). The padding is zero
in the parameters, gradients and moments, so it enters neither the norm
nor the update.

A spec here is a tuple of mesh axes over the flat dimension: ``()`` is
replicated, ``("fsdp",)`` partitioned.
"""

import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

from deepspeed_tpu_torch.parallel.mesh import MeshTopology

# each leaf starts on a multiple of ALIGN elements (128 bytes in bf16, what
# cuBLAS and TMA want of a base address), and every shard does too
ALIGN = 64


class ZeroShardingRules:
    """Which state a ZeRO stage partitions over ``fsdp`` on ``topo``."""

    def __init__(self, topo: MeshTopology, stage: int,
                 param_persistence_threshold: int = 0):
        self.topo = topo
        self.stage = stage
        self.persistence_threshold = param_persistence_threshold

    def _fsdp(self, shape) -> Tuple[str, ...]:
        if self.topo.size("fsdp") <= 1 or not shape:
            return ()
        return ("fsdp",)

    def partitions_param(self, shape) -> bool:
        """Whether stage 3 keeps only a shard of a parameter of ``shape``
        (on a one-rank axis too: a 1-way partition, the same path)."""
        return (self.stage >= 3
                and math.prod(shape) >= max(self.persistence_threshold, 1))

    def param_spec(self, path, shape) -> Tuple[str, ...]:
        return self._fsdp(shape) if self.partitions_param(shape) else ()

    def grad_accum_spec(self, path, shape) -> Tuple[str, ...]:
        return self._fsdp(shape) if self.stage >= 2 else ()

    def opt_state_spec(self, param_path, shape) -> Tuple[str, ...]:
        return self._fsdp(shape) if self.stage >= 1 else ()

    @property
    def shards_optimizer(self) -> bool:
        return self.stage >= 1

    @property
    def shards_grad_accum(self) -> bool:
        return self.stage >= 2


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


class FlatGroup:
    """The parameters of one dtype laid end to end: leaf i at
    ``offsets[i]``, ``numels[i]`` elements; ``padded`` elements in all,
    ``world`` shards of ``shard_size``, this rank's from ``start``."""

    def __init__(self, dtype, names: Sequence[str], shapes, world: int,
                 rank: int):
        self.dtype = dtype
        self.names = list(names)
        self.shapes = [tuple(s) for s in shapes]
        self.numels = [math.prod(s) for s in self.shapes]
        self.offsets, end = [], 0
        for n in self.numels:
            self.offsets.append(end)
            end = _round_up(end + n, ALIGN)
        self.numel = end
        self.world, self.rank = world, rank
        self.padded = _round_up(max(end, 1), world * ALIGN)
        self.shard_size = self.padded // world
        self.start = rank * self.shard_size
        self.end = self.start + self.shard_size

    def overlaps(self, lo: int, hi: int) -> Iterator[Tuple[int, int, int]]:
        """``(leaf, a, b)`` for each leaf that meets ``[lo, hi)``: the
        global element range ``[a, b)`` they share."""
        for i, (o, n) in enumerate(zip(self.offsets, self.numels)):
            a, b = max(o, lo), min(o + n, hi)
            if a < b:
                yield i, a, b

    def shard_overlaps(self, rank: int) -> List[Tuple[int, int, int]]:
        lo = rank * self.shard_size
        return list(self.overlaps(lo, lo + self.shard_size))

    def shard_runs(self) -> List[Tuple[int, int, int]]:
        """This rank's shard as consecutive runs ``(leaf, a, b)`` that cover
        it, ``[a, b)`` in the shard's own offsets; ``leaf`` is
        ``len(names)`` over padding. A leaf meets a contiguous shard in at
        most one run."""
        runs, at, pad = [], self.start, len(self.names)
        for i, a, b in self.overlaps(self.start, self.end):
            if a > at:
                runs.append((pad, at - self.start, a - self.start))
            runs.append((i, a - self.start, b - self.start))
            at = b
        if at < self.end:
            runs.append((pad, at - self.start, self.shard_size))
        return runs

    def describe(self) -> Dict[str, object]:
        return {"dtype": str(self.dtype).replace("torch.", ""),
                "numel": self.numel, "padded": self.padded,
                "world": self.world, "shard_size": self.shard_size,
                "leaves": {n: [o, k] for n, o, k in
                           zip(self.names, self.offsets, self.numels)}}


class FlatPartition:
    """The named parameters grouped by dtype (in order of first
    appearance), one ``FlatGroup`` each, partitioned ``world`` ways with
    this process at ``rank``."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 world: int, rank: int):
        by_dtype: Dict[torch.dtype, List[Tuple[str, torch.Tensor]]] = {}
        for name, p in named_params:
            by_dtype.setdefault(p.dtype, []).append((name, p))
        self.groups = [FlatGroup(dtype, [n for n, _ in items],
                                 [p.shape for _, p in items], world, rank)
                       for dtype, items in by_dtype.items()]

    def flatten(self, named_params) -> List[torch.Tensor]:
        """One zero-padded buffer per group holding the parameters' values;
        each parameter becomes a view of its buffer (``p.data``), so the
        module trains the buffer in place."""
        params = dict(named_params)
        flats = []
        for group in self.groups:
            first = params[group.names[0]]
            flat = torch.zeros(group.padded, dtype=group.dtype,
                               device=first.device)
            with torch.no_grad():
                for name, o, n, shape in zip(group.names, group.offsets,
                                             group.numels, group.shapes):
                    view = flat[o:o + n].view(shape)
                    view.copy_(params[name])
                    params[name].data = view
            flats.append(flat)
        return flats

    def views(self, flats: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each parameter's view of ``flats`` (buffers laid out as
        ``flatten``'s), by name."""
        out = {}
        for group, flat in zip(self.groups, flats):
            for name, o, n, shape in zip(group.names, group.offsets,
                                         group.numels, group.shapes):
                out[name] = flat[o:o + n].view(shape)
        return out
