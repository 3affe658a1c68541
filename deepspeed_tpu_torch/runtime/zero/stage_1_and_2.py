"""ZeRO stages 0-2 over flat buffers and ``torch.distributed`` (the
port's form of the JAX engine's sharded step: the rules of
``runtime/zero/sharding.py``, which in JAX XLA turns into "reduce-scatter
grads into the update, all-gather new params out"; the reference's
``DeepSpeedZeroOptimizer``, ``stage_1_and_2.py``).

``ZeroOptimizer`` owns the flat buffers of a data-parallel engine:

* the parameters, one buffer per dtype (``FlatPartition``), which the
  module's parameters are views of; rank 0's values are broadcast at
  construction, so every rank starts from the same weights;
* the gradients, one full buffer per dtype in the communication dtype
  (``communication_data_type``, default the parameters' dtype): after the
  backward the engine copies each ``p.grad`` into its view
  (``collect_grads``), which costs one read of autograd's gradients and one
  write of the buffer, and keeps autograd's own buffers alive until then;
* at stages 1-2, each rank's shard of the reduced gradient, and the inner
  optimizer (B4, AdamW, LAMB, Adagrad or SGD) over the rank's shard of
  each parameter buffer: one tensor per dtype, so B4 is one launch per
  dtype over ``N / w`` elements;
* with gradient accumulation, f32 accumulators: full buffers at stages 0
  and 1 (replicated, as the JAX engine's ``grad_accum_spec`` below stage
  2), the rank's shard at stages 2 and 3.

At stage 3 the buffers above hold only the leaves under the persistence
threshold, which take stage 2's path; the partitioned leaves live as
per-unit shards (``runtime/zero/stage3.py``), which the inner optimizer
updates beside the whole leaves' shards.

The exchanges, each one collective on one flat buffer: stage 0 all-reduces
the gradient (every rank then updates everything); stages 1-2
reduce-scatter it into the rank's shard (and all-reduce the shard over
``dp`` when both ``dp`` and ``fsdp`` exceed 1), update the shard and
all-gather the parameter buffer. Gradient accumulation exchanges every
micro step, as the JAX step does inside its backward: stages 0-1
all-reduce into the full accumulators, stage 2 reduce-scatters into the
shard accumulator. The norm of a shard is one all-reduce of its square,
the fp16 overflow flag one all-reduce, so every rank clips by the global
norm and skips the same steps. Every call is a collective of the whole
data-parallel group and must be made by every rank in the same order.

``state_dict()`` gathers the state by parameter name (the format of the
one-card engine, at any world); ``load_state_dict`` copies each rank's
slice of each tensor into its live shard, so a load needs no new graph and
reshards to any world or stage.

Under tensor and expert parallelism (``parallel``: the model's config and
its ``ParallelLayout``) the leaves are the rank's tp/ep shards, and the
data-parallel group above is the ranks that share the rank's tp and ep
coordinates. The loss weights are summed over every batch rank (dp, fsdp
and ep: ``BATCH_AXES``). Expert leaves reduce their gradients over (dp,
fsdp) only, never over ep, which would mix different experts; every other
leaf also over ep: with ep > 1 the expert leaves lie last in each dtype's
buffer, so the others' gradient is one prefix, all-reduced over ep before
the exchange. The gradient norm weights each leaf's square by the inverse
of the number of tp x ep ranks that hold the same copy (a leaf split over
tp counts on every tp rank, a replicated one once), summed over (fsdp,)
ep and tp: the single-device norm.
"""

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.parallel.mesh import BATCH_AXES
from deepspeed_tpu_torch.runtime.loss_scaler import has_overflow
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, get_global_norm
from deepspeed_tpu_torch.runtime.zero.sharding import (FlatPartition,
                                                       ZeroShardingRules)

# the data-parallel axes: the loss's weights and the stage-0 exchange span
# them; the partition runs over fsdp
DATA_AXES = ("dp", "fsdp")


class ZeroOptimizer:
    """The data-parallel update of ``named_params`` under ``rules`` (a
    ``ZeroShardingRules``: the topology and the stage, 0-2; at stage 3
    ``named_params`` are the whole (persistent) leaves, which take stage
    2's path, and ``units`` the partitioned ones: ``runtime/zero/stage3.py``).
    ``build(params, names, runs, reduce)`` makes the inner optimizer over
    the rank's shards; ``runs`` (each shard's leaf runs, for LAMB) and
    ``reduce`` (the all-reduce of per-leaf sums over the partition) are for
    optimizers whose update is not elementwise.

    ``units`` (stage 3) each hold ``groups`` (``FlatGroup``s over the
    partition axis), ``shards`` (this rank's shard of each, a parameter the
    update changes in place) and ``take_grads()`` (each shard's reduced
    gradient after a backward, handed over once); their groups follow the
    whole leaves' in ``groups``, ``shard_params`` and the inner optimizer,
    so B4 stays one launch over every shard."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.Tensor]],
                 rules: ZeroShardingRules, build: Callable,
                 comm_dtype: Optional[torch.dtype] = None, units=(),
                 parallel=None):
        self.rules = rules
        self.topology = topology = rules.topo
        self.sharded = rules.shards_optimizer
        self.parallel = parallel
        fsdp = topology.size("fsdp")
        world, rank = ((fsdp, topology.axis_index("fsdp")) if self.sharded
                       else (1, 0))
        named = list(named_params)
        self._ep = parallel[1].ep if parallel is not None else 1
        if self._ep > 1:
            # the expert leaves last (a stable sort): the rest is a prefix
            named.sort(key=lambda item: _is_expert(item[0]))
        self.params = [p for _, p in named]
        self.partition = FlatPartition(named, world, rank)
        whole = self.partition.groups
        self.flat_params = self.partition.flatten(named)
        for flat in self.flat_params:
            comm.broadcast(flat, DATA_AXES, root=0)
        self.flat_grads = [torch.zeros(g.padded, dtype=comm_dtype or g.dtype,
                                       device=flat.device)
                           for g, flat in zip(whole, self.flat_params)]
        grad_views = self.partition.views(self.flat_grads)
        self._grad_views = [grad_views[n] for n, _ in named]
        self.grad_shards = ([torch.zeros(g.shard_size, dtype=f.dtype,
                                         device=f.device)
                             for g, f in zip(whole, self.flat_grads)]
                            if self.sharded else None)
        self.units = list(units)
        self.groups = whole + [g for u in self.units for g in u.groups]
        self.names = [n for g in self.groups for n in g.names]
        self.shard_params = ([flat[g.start:g.end]
                              for g, flat in zip(whole, self.flat_params)]
                             + [s for u in self.units for s in u.shards])
        # the f32 gradient sums of an accumulation window (made by the
        # first micro step: a gas-1 engine never needs them)
        self.accumulators = None
        self.local_overflow = None
        # where each dtype's expert leaves begin (ep > 1)
        self._dense_end = [
            next((o for n, o in zip(g.names, g.offsets) if _is_expert(n)),
                 g.padded) for g in whole] if self._ep > 1 else []
        if parallel is not None:
            self._norm_plan()
        self.inner = build(self.shard_params,
                           [f"flat.{g.describe()['dtype']}" for g in whole]
                           + [f"{u.name}.flat.{g.describe()['dtype']}"
                              for u in self.units for g in u.groups],
                           [(g.shard_runs(), len(g.names))
                            for g in self.groups],
                           self._reduce_partition)

    # -- the inner optimizer's step surface -------------------------------
    @property
    def count(self) -> int:
        return self.inner.count

    def prepare(self, lr=None):
        self.inner.prepare(lr)

    def commit(self, updated: bool = True):
        self.inner.commit(updated)

    # -- collectives on the flat buffers -----------------------------------
    def _reduce_partition(self, x: torch.Tensor) -> torch.Tensor:
        """Sum ``x`` over the ranks that hold the other shards."""
        return comm.all_reduce(x, "fsdp") if self.sharded else x

    def data_parallel_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the batch ranks (dp, fsdp, ep) of a 0-dim value, in
        f32 (a new tensor)."""
        return comm.all_reduce(x.detach().float().clone(), BATCH_AXES)

    def collect_grads(self):
        """Copy each whole parameter's ``.grad`` into the gradient buffer (0
        for a parameter without one) and clear it."""
        dst, src = [], []
        for view, p in zip(self._grad_views, self.params):
            if p.grad is None:
                view.zero_()
            else:
                dst.append(view)
                src.append(p.grad)
            p.grad = None
        if dst:
            torch._foreach_copy_(dst, src)

    def _exchange(self, shard: bool) -> List[torch.Tensor]:
        """The reduced gradient of every whole group: the full buffers
        summed over the data-parallel ranks, or (``shard``) this rank's
        shard of the sum; then the units' shards, which their backward
        reduced already. Under ep > 1 the non-expert prefix of each buffer
        is first summed over ep."""
        if self._ep > 1:
            for flat, end in zip(self.flat_grads, self._dense_end):
                if end:
                    comm.all_reduce(flat[:end], "ep")
        if not shard:
            return [comm.all_reduce(f, DATA_AXES) for f in self.flat_grads]
        out = []
        for flat, g_shard in zip(self.flat_grads, self.grad_shards):
            comm.reduce_scatter(flat, "fsdp", out=g_shard)
            if self.topology.size("dp") > 1:
                comm.all_reduce(g_shard, "dp")
            out.append(g_shard)
        return out + [g for u in self.units for g in u.take_grads()]

    def reduce_grads(self) -> List[torch.Tensor]:
        """gas 1: the gradients of this rank's update (the summed full
        buffers at stage 0, the rank's shards at stages 1-3)."""
        return self._exchange(self.sharded)

    def make_accumulators(self):
        """The f32 accumulators, once: this rank's shard at stage 2, the
        full buffers below."""
        if self.accumulators is None:
            shard = self.rules.shards_grad_accum
            self.accumulators = [
                torch.zeros(g.shard_size if shard else g.padded,
                            dtype=torch.float32, device=s.device)
                for g, s in zip(self.groups, self.shard_params)]

    def accumulate(self):
        """A micro step: the exchanged gradients added in f32 to the
        accumulators (full at stages 0-1, the shard at stages 2-3)."""
        for acc, g in zip(self.accumulators,
                          self._exchange(self.rules.shards_grad_accum)):
            acc.add_(g)

    def accumulated(self) -> List[torch.Tensor]:
        """The accumulators' part that this rank updates."""
        if self.sharded and not self.rules.shards_grad_accum:
            return [acc[g.start:g.end]
                    for acc, g in zip(self.accumulators, self.groups)]
        return list(self.accumulators)

    def zero_accumulators(self):
        for acc in self.accumulators or ():
            acc.zero_()

    @property
    def _shard_axis(self) -> Optional[str]:
        """The axis a rank's part of the gradient is one shard over (None
        at stage 0: every rank holds the whole reduced gradient)."""
        return "fsdp" if self.sharded else None

    def _norm_plan(self):
        """Under a layout: each leaf's run in this rank's part of every
        group, and the weight of its square (1 / the copies of it over tp
        x ep), a device constant made once."""
        from deepspeed_tpu_torch.parallel.tensor import (replication,
                                                         whole_shapes)

        cfg, layout = self.parallel
        shapes = whole_shapes(cfg)
        runs, weights = [], []
        for g, group in enumerate(self.groups):
            if self.sharded:
                parts = [(i, a, b) for i, a, b in group.shard_runs()
                         if i < len(group.names)]
            else:
                parts = [(i, o, o + n) for i, (o, n) in
                         enumerate(zip(group.offsets, group.numels))]
            for i, a, b in parts:
                name = group.names[i]
                runs.append((g, a, b))
                weights.append(1.0 / replication(name, shapes[name], cfg,
                                                 layout))
        self._norm_runs = runs
        self._norm_weights = torch.tensor(weights, dtype=torch.float32,
                                          device=self.shard_params[0].device)
        self._norm_axes = (("fsdp",) if self.sharded else ()) + ("ep", "tp")

    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The f32 2-norm of the whole gradient from this rank's part."""
        if self.parallel is None:
            return get_global_norm(grads, axis=self._shard_axis)
        views = [grads[g][a:b] for g, a, b in self._norm_runs]
        norms = torch._foreach_norm(views, 2, dtype=torch.float32)
        sq = (torch.stack(norms).square() * self._norm_weights).sum()
        return comm.all_reduce(sq, self._norm_axes).sqrt()

    def clip(self, grads: Sequence[torch.Tensor], max_norm) -> torch.Tensor:
        """Clip this rank's part by the global norm; returns the norm."""
        if self.parallel is None:
            return clip_grad_norm_(grads, max_norm, axis=self._shard_axis)
        from deepspeed_tpu_torch.runtime.utils import clip_factor

        norm = self.global_norm(grads)
        torch._foreach_mul_(list(grads), clip_factor(norm, max_norm))
        return norm

    def overflow(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Whether any rank's part holds an inf or a NaN (a device bool).
        ``local_overflow`` keeps this rank's own flag, before the
        all-reduce (a diagnostic: in a captured step, the graph's tensor)."""
        self.local_overflow = has_overflow(grads)
        if self.parallel is not None:
            return comm.all_reduce(self.local_overflow.float(),
                                   self._norm_axes) > 0
        if not self.sharded:
            return self.local_overflow
        return self._reduce_partition(self.local_overflow.float()) > 0

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor],
              skip: Optional[torch.Tensor] = None):
        """The inner optimizer over this rank's shards (each gradient cast
        to its parameter's dtype), then, when sharded, every rank's
        updated shard gathered into the whole parameter buffers (a unit's
        shard stays a shard: the next forward gathers it)."""
        self.inner.apply([g.to(p.dtype) for g, p in
                          zip(grads, self.shard_params)], skip=skip)
        if self.sharded:
            for flat, shard in zip(self.flat_params, self.shard_params[
                    :len(self.flat_params)]):
                comm.all_gather(shard, "fsdp", out=flat)

    # -- state by parameter name -------------------------------------------
    def _gather_leaf(self, g: int, i: int, state: torch.Tensor
                     ) -> torch.Tensor:
        """Leaf ``i`` of group ``g`` of a state buffer sharded like the
        parameters (every rank's piece of it, gathered)."""
        group = self.groups[g]
        o, n = group.offsets[i], group.numels[i]
        if not self.sharded or group.world == 1:
            return state[o - group.start:o - group.start + n]
        pieces = [list(group.overlaps(q * group.shard_size,
                                      (q + 1) * group.shard_size))
                  for q in range(group.world)]
        spans = [[(a, b) for leaf, a, b in p if leaf == i] for p in pieces]
        width = max(b - a for s in spans for a, b in s)
        mine = state.new_zeros(width)
        for a, b in spans[group.rank]:
            mine[:b - a] = state[a - group.start:b - group.start]
        gathered = comm.all_gather(mine, "fsdp")
        return torch.cat([gathered[q * width:q * width + b - a]
                          for q, span in enumerate(spans) for a, b in span])

    def state_dict(self, keep: bool = True, to_host: bool = False,
                   whole: Optional[Callable] = None) -> Dict[str, Any]:
        """``{"count", "state": {name: {key: tensor}}}`` by parameter name,
        each tensor the parameter's whole state, gathered from every rank
        (a collective: every rank calls it). ``keep=False`` drops the
        gathered tensors (a rank that does not write them);
        ``to_host`` copies each to the host as it arrives, so the card
        holds one at a time. ``whole(name, t)`` (a collective) makes each
        leaf's tensor whole over tp and ep first, under a layout."""
        state: Dict[str, Dict[str, torch.Tensor]] = {}
        for key in self.inner.STATE:
            buffers = getattr(self.inner, key)
            for g, group in enumerate(self.groups):
                for i, name in enumerate(group.names):
                    t = self._gather_leaf(g, i, buffers[g]).view(
                        group.shapes[i])
                    if whole is not None:
                        t = whole(name, t)
                    if not keep:
                        continue
                    t = t.to("cpu", copy=True) if to_host else t.clone()
                    state.setdefault(name, {})[key] = t
        return {"count": self.inner.count, "state": state}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]):
        """Copy this rank's slice of each named tensor of ``sd`` (a
        ``state_dict()`` of any world or stage, or of a one-card engine)
        into the live shards, in place."""
        state = sd["state"]
        missing = [n for n in self.names if n not in state]
        unknown = [n for n in state if n not in set(self.names)]
        if missing or unknown:
            raise KeyError(f"optimizer state: missing {missing}, "
                           f"unknown {unknown}")
        for key in self.inner.STATE:
            buffers = getattr(self.inner, key)
            for g, group in enumerate(self.groups):
                for i, name in enumerate(group.names):
                    self._load_leaf(g, i, buffers[g], state[name][key],
                                    f"optimizer state {name}.{key}")
        self.inner.count = int(sd["count"])

    def _load_leaf(self, g: int, i: int, buf: torch.Tensor,
                   src: torch.Tensor, what: str):
        """Copy this rank's slice of leaf ``i`` of group ``g`` from the
        whole tensor ``src`` into ``buf``, a buffer sharded like the
        parameters (nothing when the leaf lies in other ranks' shards)."""
        group = self.groups[g]
        if tuple(src.shape) != group.shapes[i]:
            raise ValueError(f"{what}: shape {tuple(src.shape)}, want "
                             f"{group.shapes[i]}")
        o = group.offsets[i]
        for leaf, a, b in group.overlaps(group.start, group.end):
            if leaf == i:
                buf[a - group.start:b - group.start].copy_(
                    src.reshape(-1)[a - o:b - o])


def _is_expert(name: str) -> bool:
    return ".experts." in f".{name}"
