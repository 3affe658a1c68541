"""ZeRO stage 3 over NCCL: partitioned parameters, gathered per unit on use
(counterpart of the JAX engine's stage 3, where each parameter at or above
``param_persistence_threshold`` elements is sharded over ``fsdp`` and XLA
places the per-layer all-gathers, ``deepspeed_tpu/runtime/zero/
sharding.py:124-130``; and of the reference's ``stage3.py`` /
``partition_parameters.py``).

**Units.** The model is cut into units: each block of its one
``nn.ModuleList`` (``GPT.h[i]``, or a BERT's ``encoder.layer[i]``), and one
outer unit holding the rest (the token embedding, which a tied head reads
too, the position embedding when the model has one, the final norm, and an
untied ``lm_head`` and its bias; a BERT's embeddings, their LayerNorm and
the MLM head).
A unit's parameters of at least
``stage3_param_persistence_threshold`` elements
(``ZeroShardingRules.partitions_param``) are laid out as stages 1-2 lay
the whole model out (``FlatPartition``: one buffer per dtype, leaves at
``ALIGN``) and partitioned over ``fsdp``: a rank keeps only its shard of
each unit's buffer (``_Unit.shards``), and the inner optimizer updates the
shards in place, beside the whole leaves' shards, in one B4 launch. The
leaves under the threshold stay whole on every rank and take stage 2's
path (``ZeroOptimizer``'s whole groups: reduce-scatter, update of the
shard, all-gather). So each gather and each reduce-scatter is one
collective on one unit's buffer of one dtype (~100 MB a block of GPT-2
1.3B in bf16): few and large.

**Gather on use.** ``_GatherUnit`` is an autograd Function. Its forward
all-gathers a unit's shard into a full buffer; its backward reduce-scatters
the full buffer's gradient into a shard (SUM, in the communication dtype)
and, when ``dp`` > 1, all-reduces that over ``dp``, and hands it to the
optimizer (``_Unit.take_grads``) rather than to autograd. The unit's module
then runs on views of the full buffer, bound by
``torch.func.functional_call``: ``ZeroStage3Optimizer.forward`` gathers the
outer unit once per forward and calls the model with it (the embedding and
the head, tied or not, share one gather, and one reduce-scatter at the end
of the backward), and the model's ``block_hook`` gathers each block's
unit as the block runs. A model names its blocks (``blocks``, a
``ModuleList``, and ``block_prefix``: ``h`` for a ``GPT``,
``encoder.layer`` for a ``BertForPreTraining``) and runs each through its
``block_hook`` when one is set: the engine cannot rebind a block's
parameters from outside without renaming them. Under full
remat the gather runs inside the function that ``torch.utils.checkpoint``
wraps (non-reentrant), so the recompute gathers again and the backward
keeps no full buffer past its block; without remat, autograd keeps every
block's gathered views until that block's backward, so the parameters are
whole during the backward and stage 3 saves gradient and optimizer memory
only.

**Collectives off the caller's thread.** On a card the backward, and with it
every reduce-scatter and every recompute's gather, runs on autograd's
device thread, not on the thread that captures the step. They are still
captured: a collective joins the capture through the stream it is issued
on, the autograd engine issues each node's backward on its forward's
stream, and the step is captured with ``capture_error_mode="thread_local"``
(``runtime/compiled_step.py``). The order is the graph's, the same on every
rank.

**Placeholders.** A partitioned ``nn.Parameter`` keeps its name and becomes an
empty tensor (``param.data = torch.empty(0)``, as the reference does), with
``ds_shape``, ``ds_name`` and ``ds_zero`` (this optimizer), so
``module.state_dict()`` keeps its keys and holds placeholders.
``gathered_state_dict`` (the engine's ``params``, checkpoints,
``save_16bit_model``) and ``zero.GatheredParameters`` give whole tensors.
``stage3_prefetch_bucket_size``, ``max_live_parameters`` and
``max_reuse_distance`` stay inert, as in the JAX package, where XLA
schedules the gathers: here each gather runs when its unit runs, with no
prefetch (ROADMAP A.3).
"""

from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.runtime.zero.sharding import (FlatPartition,
                                                       ZeroShardingRules)
from deepspeed_tpu_torch.runtime.zero.stage_1_and_2 import (DATA_AXES,
                                                            ZeroOptimizer)


class _GatherUnit(torch.autograd.Function):
    """Group ``k`` of ``unit``, whole: an all-gather of the rank's ``shard``
    over ``fsdp``; the backward reduce-scatters the gradient into the unit
    (and returns none to autograd)."""

    @staticmethod
    def forward(ctx, shard, unit, k):
        ctx.unit, ctx.k = unit, k
        return unit.gather(k)

    @staticmethod
    def backward(ctx, grad):
        ctx.unit.reduce_grad(ctx.k, grad)
        return None, None, None


class _Unit:
    """One unit's partitioned leaves (``named``, names under ``prefix`` in
    ``module``): one ``FlatGroup`` per dtype over the ``fsdp`` axis, this
    rank's shard of each, and the reduced gradients of the last backward.
    Rank 0's values are broadcast at construction; each parameter then
    becomes a placeholder."""

    def __init__(self, name: str, module: torch.nn.Module, prefix: str,
                 named, world: int, rank: int, dp: int,
                 comm_dtype: Optional[torch.dtype]):
        self.name, self.module = name, module
        self.dp, self.comm_dtype = dp, comm_dtype
        self.local = {n: n[len(prefix):] for n, _ in named}
        self.partition = FlatPartition(named, world, rank)
        self.groups = self.partition.groups
        self.shards, self.splits = [], []
        for group, full in zip(self.groups, self.partition.flatten(named)):
            comm.broadcast(full, DATA_AXES, root=0)
            self.shards.append(
                full[group.start:group.end].clone().requires_grad_(True))
            # the full buffer as [leaf, gap, leaf, gap, ...]: one split
            # gives every leaf, and its backward is one concatenation
            ends = group.offsets[1:] + [group.padded]
            self.splits.append([x for o, n, e in zip(group.offsets,
                                                     group.numels, ends)
                                for x in (n, e - o - n)])
            del full
        for _, p in named:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.grads: List[Optional[torch.Tensor]] = [None] * len(self.groups)

    def gather(self, k: int) -> torch.Tensor:
        """Group ``k``'s whole buffer (a new tensor; no autograd)."""
        shard = self.shards[k].detach()
        return comm.all_gather(
            shard, "fsdp", out=shard.new_empty(self.groups[k].padded))

    def reduce_grad(self, k: int, grad: torch.Tensor):
        """The backward of a gather: this rank's shard of the gradient
        summed over ``fsdp`` (and ``dp``), added to ``grads[k]``."""
        if self.comm_dtype is not None:
            grad = grad.to(self.comm_dtype)
        out = grad.new_empty(self.groups[k].shard_size)
        comm.reduce_scatter(grad.contiguous(), "fsdp", out=out)
        if self.dp > 1:
            comm.all_reduce(out, "dp")
        self.grads[k] = out if self.grads[k] is None else self.grads[k] + out

    def take_grads(self) -> List[torch.Tensor]:
        """Each group's reduced shard gradient since the last call (zeros
        for a group the backward did not reach), handed over once."""
        out = [g if g is not None else torch.zeros(
                   grp.shard_size, dtype=self.comm_dtype or grp.dtype,
                   device=s.device)
               for g, grp, s in zip(self.grads, self.groups, self.shards)]
        self.grads = [None] * len(self.groups)
        return out

    def bind(self) -> Dict[str, torch.Tensor]:
        """The partitioned leaves by their name in ``module``, as views of
        freshly gathered buffers (differentiable: the gather's backward
        reduce-scatters)."""
        out = {}
        for k, (group, shard) in enumerate(zip(self.groups, self.shards)):
            pieces = _GatherUnit.apply(shard, self, k).split(self.splits[k])
            for j, (name, shape) in enumerate(zip(group.names,
                                                  group.shapes)):
                out[self.local[name]] = pieces[2 * j].view(shape)
        return out

    def whole(self) -> Dict[str, torch.Tensor]:
        """The partitioned leaves, whole, by full name (views of gathered
        buffers; no autograd)."""
        out = {}
        for k, group in enumerate(self.groups):
            full = self.gather(k)
            for name, o, n, shape in zip(group.names, group.offsets,
                                         group.numels, group.shapes):
                out[name] = full[o:o + n].view(shape)
        return out


class ZeroStage3Optimizer(ZeroOptimizer):
    """Stage 3 of a ``GPT`` or a ``BertForPreTraining`` (``module``) under
    ``rules``: one ``_Unit`` per block of ``module.blocks`` and one outer
    unit, and ``ZeroOptimizer``'s stage-2 path for the leaves under the
    threshold. Installs ``run_block`` as the model's ``block_hook``; the
    engine calls the model through ``forward``."""

    def __init__(self, module: torch.nn.Module, rules: ZeroShardingRules,
                 build, comm_dtype: Optional[torch.dtype] = None,
                 parallel=None):
        topo = rules.topo
        world, rank = topo.size("fsdp"), topo.axis_index("fsdp")
        named = list(module.named_parameters())
        split = {n for n, p in named if rules.partitions_param(p.shape)}

        def unit(name, mod, prefix, leaves):
            return _Unit(name, mod, prefix,
                         [(n, p) for n, p in named if n in leaves], world,
                         rank, topo.size("dp"), comm_dtype)

        prefix = module.block_prefix
        self.outer = unit("outer", module, "",
                          {n for n in split
                           if not n.startswith(f"{prefix}.")})
        self.blocks = [unit(f"{prefix}.{i}", block, f"{prefix}.{i}.",
                            {n for n in split
                             if n.startswith(f"{prefix}.{i}.")})
                       for i, block in enumerate(module.blocks)]
        super().__init__([(n, p) for n, p in named if n not in split], rules,
                         build, comm_dtype, units=[self.outer] + self.blocks,
                         parallel=parallel)
        self.module = module
        self._unit_of = {id(u.module): u for u in self.blocks}
        self._where = {n: (g, i) for g, group in enumerate(self.groups)
                       for i, n in enumerate(group.names) if n in split}
        for n, p in named:
            if n in split:
                g, i = self._where[n]
                p.ds_shape, p.ds_name = self.groups[g].shapes[i], n
                p.ds_zero = self
        module.block_hook = self.run_block

    def forward(self, **batch):
        """The model on ``batch`` with the outer unit gathered."""
        return torch.func.functional_call(self.module, self.outer.bind(), (),
                                          batch)

    def run_block(self, block, *args, **kwargs):
        """``block(*args, **kwargs)`` with its unit gathered (the model's
        ``block_hook``)."""
        return torch.func.functional_call(
            block, self._unit_of[id(block)].bind(), args, kwargs)

    # -- whole parameters ---------------------------------------------------
    @torch.no_grad()
    def gathered_state_dict(self, keep: bool = True, to_host: bool = False
                            ) -> Optional[Dict[str, torch.Tensor]]:
        """The module's ``state_dict`` with every partitioned parameter
        whole (gathered unit by unit: a collective, every rank calls it).
        The whole tensors are views of new buffers, one per unit and
        dtype. ``keep=False`` returns None (a rank that writes nothing);
        ``to_host`` copies each tensor to the host as it comes, so the card
        holds one unit at a time."""
        whole = {}
        for u in self.units:
            for name, t in u.whole().items():
                if keep:
                    whole[name] = t.to("cpu", copy=True) if to_host else t
        if not keep:
            return None
        return {k: whole[k] if k in whole else
                (v.to("cpu", copy=True) if to_host else v)
                for k, v in self.module.state_dict().items()}

    @torch.no_grad()
    def gather_param(self, p: torch.Tensor) -> torch.Tensor:
        """A partitioned parameter, whole (a collective over ``fsdp``)."""
        g, i = self._where[p.ds_name]
        return self._gather_leaf(g, i, self.shard_params[g]).view(p.ds_shape)

    @torch.no_grad()
    def load_param(self, p: torch.Tensor, src: torch.Tensor):
        """Copy this rank's slice of the whole tensor ``src`` into the shard
        that holds the partitioned parameter ``p``."""
        g, i = self._where[p.ds_name]
        self._load_leaf(g, i, self.shard_params[g], src,
                        f"model state {p.ds_name}")
