"""Tensor and expert parallelism with the collectives written out (the
port's counterpart of what GSPMD does with the JAX package's specs:
``gpt_tp_rules``, ``deepspeed_tpu/models/transformer_lm.py:1046-1076``,
the vocab-parallel lookup :292-367, and ``moe_param_spec`` /
``_ep_constraint``, ``deepspeed_tpu/moe/layer.py:35-47, 132-154``).

JAX states each leaf's ``PartitionSpec`` and lets XLA insert the
collectives. The port has no partitioner: every rank builds only its own
shard of each leaf (``ParallelLayout``, one per model), and the model calls
the collectives itself, Megatron-style:

* ``copy_to_tp`` (Megatron's *f*): identity forward, all-reduce over ``tp``
  backward. It sits on the input of every column-parallel product
  (``c_attn``, ``c_fc``/``c_gate``, the experts' ``wi``/``wg``, the
  vocab-parallel head), so the gradient of the replicated activation, and
  through it of every LayerNorm and every replicated leaf, is the sum of
  the ranks' parts and equal on every rank. Without it each rank would
  see only its own part.
* ``reduce_from_tp`` (*g*): all-reduce forward, identity backward, on the
  output of every row-parallel product (``c_proj``s, the experts' ``wo``)
  before its bias, and of the vocab-parallel lookup.
* ``VocabParallelCrossEntropy``: the loss over vocab-sharded logits, with an
  all-reduce of the row max, of the sum of exponentials and of the target
  logit; its backward is each rank's slice of ``softmax - onehot``.
* ``all_to_all_ep`` and ``gather_from_ep``: the expert exchange.

The layout of each leaf (``leaf_spec``) is JAX's rule with one deliberate
difference: JAX splits ``c_attn``'s fused ``[q | k | v]`` output dimension
contiguously, which does not fall on heads (GSPMD reshards to fit); the
port's rank r holds the q, k and v columns of its own heads (query heads
``[r H/tp, (r+1) H/tp)``, KV heads likewise, or, when ``Hkv < tp`` and
``tp % Hkv == 0``, the one KV head its queries read, replicated as Megatron
does). So a rank's ``c_attn`` is a column permutation of JAX's shard, and
``shard_state_dict`` / ``gather_state_dict`` apply and undo it. Two more
leaves are split where JAX keeps them whole over ``tp`` and reshards:
an untied head's ``lm_head_bias`` (with the head's vocabulary) and the
experts' ``bi`` (with ``wi``'s hidden dimension). A dimension that ``tp``
does not divide stays whole, as JAX's ``ZeroShardingRules`` strips it: the
layer then runs replicated, with no collective.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import torch

# the leaves split over tp, and the dimension of the TORCH tensor (Dense
# weights are [out, in]); "qkv" is c_attn's head-aligned split of dim 0
_COLUMN = ("attn.c_attn", "mlp.c_fc", "mlp.c_gate")
_ROW = ("attn.c_proj", "mlp.c_proj")


@dataclasses.dataclass(frozen=True)
class ParallelLayout:
    """One rank's place on the ``tp`` and ``ep`` axes. ``rows_split``: the
    rows are split over ``ep`` as a batch axis (training: each rank routes
    its own rows, and the expert exchange is an all-to-all); False when
    every ``ep`` rank holds the same rows (serving: each rank runs its own
    experts on their slots and an all-gather over ``ep`` combines them)."""

    tp: int = 1
    tp_rank: int = 0
    ep: int = 1
    ep_rank: int = 0
    rows_split: bool = True

    @classmethod
    def from_topology(cls, topo, rows_split: bool = True
                      ) -> "ParallelLayout":
        return cls(tp=topo.size("tp"), tp_rank=topo.axis_index("tp"),
                   ep=topo.size("ep"), ep_rank=topo.axis_index("ep"),
                   rows_split=rows_split)

    def check(self, cfg) -> None:
        """Raise for a config this layout cannot split (naming the
        constraint) or a feature not ported under ``tp`` yet."""
        H, Hkv, tp = cfg.n_head, cfg.kv_heads, self.tp
        if H % tp:
            raise ValueError(
                f"tensor parallelism splits attention by heads: n_head "
                f"({H}) must be divisible by tp ({tp})")
        if Hkv % tp and tp % Hkv:
            raise ValueError(
                f"n_kv_head ({Hkv}) must be divisible by tp ({tp}), or tp "
                "a multiple of it (the KV heads are then replicated)")
        if cfg.is_moe and cfg.moe_num_experts % self.ep:
            raise ValueError(
                f"moe_num_experts ({cfg.moe_num_experts}) must be divisible "
                f"by ep ({self.ep})")
        if self.ep > 1 and not cfg.is_moe:
            raise ValueError("ep > 1 needs a mixture-of-experts model "
                             "(moe_num_experts > 0)")

    # -- the local widths -------------------------------------------------
    def heads(self, cfg) -> Tuple[int, int]:
        """This rank's (query heads, KV heads)."""
        Hkv = cfg.kv_heads
        return cfg.n_head // self.tp, (Hkv // self.tp if Hkv % self.tp == 0
                                       else 1)

    def head_start(self, cfg) -> int:
        """The first query head this rank holds (its heads are
        ``head_start .. + heads(cfg)[0]``, as ``c_attn``'s shard takes
        them)."""
        return self.tp_rank * (cfg.n_head // self.tp)

    def kv_head_start(self, cfg) -> int:
        """The first KV head this rank holds."""
        Hkv = cfg.kv_heads
        if Hkv % self.tp == 0:
            return self.tp_rank * (Hkv // self.tp)
        return self.tp_rank // (self.tp // Hkv)

    def splits(self, n: int) -> bool:
        """Whether a dimension of ``n`` is split over tp (JAX's rule: a
        dimension tp does not divide stays whole)."""
        return n % self.tp == 0

    def vocab_start(self, cfg) -> int:
        return self.tp_rank * (cfg.vocab_size // self.tp)

    def vocab_parallel(self, cfg) -> bool:
        return self.splits(cfg.vocab_size)

    def local_experts(self, cfg) -> Tuple[int, int]:
        """(first expert, count) of this rank's experts."""
        return self.local_experts_of(cfg.moe_num_experts)

    def local_experts_of(self, num_experts: int) -> Tuple[int, int]:
        n = num_experts // self.ep
        return self.ep_rank * n, n


# ---------------------------------------------------------------------------
# the per-leaf layout
# ---------------------------------------------------------------------------
def leaf_spec(name: str, shape, cfg, layout: ParallelLayout
              ) -> Tuple[Optional[object], Optional[int]]:
    """``(tp_dim, ep_dim)`` of the whole leaf ``name`` (the port's
    parameter and buffer names, ``shape`` the whole shape): ``tp_dim`` is
    the torch dimension split over tp, ``"qkv"`` for ``c_attn``'s
    head-aligned split of dim 0, or None; ``ep_dim`` the expert dimension
    split over ep, or None."""
    base, _, leaf = name.rpartition(".")
    if ".experts." in f".{name}":
        ep_dim = 0 if leaf in ("wi", "wg", "wo", "bi", "bo") else None
        tp_dim = None
        if leaf in ("wi", "wg") and layout.splits(shape[2]):
            tp_dim = 2
        elif leaf == "wo" and layout.splits(shape[1]):
            tp_dim = 1
        elif leaf == "bi" and layout.splits(shape[1]):
            tp_dim = 1
        return tp_dim, ep_dim
    if base.endswith("attn.c_attn") and leaf in ("weight", "bias",
                                                 "weight_q", "weight_scale"):
        return "qkv", None
    if base.endswith(_COLUMN) and leaf in ("weight", "bias", "weight_q",
                                          "weight_scale"):
        return (0 if layout.splits(shape[0]) else None), None
    if base.endswith(_ROW) and leaf in ("weight", "weight_q"):
        return (1 if layout.splits(shape[1]) else None), None
    if name == "wte.weight":
        return (0 if layout.splits(shape[0]) else None), None
    if name == "lm_head":
        return (1 if layout.splits(shape[1]) else None), None
    if name == "lm_head_bias":
        return (0 if layout.splits(shape[0]) else None), None
    return None, None


def _qkv_index(cfg, layout: ParallelLayout, rank: int, device=None
               ) -> torch.Tensor:
    """The rows of ``c_attn`` (dim 0 of its weight, in JAX's ``[q | k |
    v]`` order) that tp rank ``rank`` holds: its query heads', then its KV
    heads' keys and values."""
    D, H, Hkv = cfg.head_dim, cfg.n_head, cfg.kv_heads
    lay = dataclasses.replace(layout, tp_rank=rank)
    Hl, Hkvl = lay.heads(cfg)
    k0 = lay.kv_head_start(cfg)
    q0 = lay.head_start(cfg)
    q = torch.arange(q0 * D, (q0 + Hl) * D)
    k = H * D + torch.arange(k0 * D, (k0 + Hkvl) * D)
    v = (H + Hkv) * D + torch.arange(k0 * D, (k0 + Hkvl) * D)
    return torch.cat([q, k, v]).to(device)


def shard_tensor(name: str, t: torch.Tensor, cfg,
                 layout: ParallelLayout) -> torch.Tensor:
    """This rank's shard of the whole leaf ``t`` (a view where it can be,
    else a copy)."""
    tp_dim, ep_dim = leaf_spec(name, t.shape, cfg, layout)
    if ep_dim is not None:
        first, n = layout.local_experts(cfg)
        t = t.narrow(ep_dim, first, n)
    if tp_dim == "qkv":
        t = t.index_select(0, _qkv_index(cfg, layout, layout.tp_rank,
                                         t.device))
    elif tp_dim is not None:
        n = t.shape[tp_dim] // layout.tp
        t = t.narrow(tp_dim, layout.tp_rank * n, n)
    return t


def whole_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """The whole shape of every parameter and buffer of a ``GPT(cfg)``
    (built on the meta device: no memory)."""
    from deepspeed_tpu_torch.models.transformer_lm import GPT

    return {k: tuple(v.shape) for k, v in GPT(cfg).state_dict().items()}


def shard_state_dict(state: Dict[str, torch.Tensor], cfg,
                     layout: ParallelLayout) -> Dict[str, torch.Tensor]:
    """This rank's shard of every leaf of a whole ``state_dict``."""
    return {k: shard_tensor(k, v, cfg, layout) for k, v in state.items()}


def gather_tensor(name: str, t: torch.Tensor, shape, cfg,
                  layout: ParallelLayout) -> torch.Tensor:
    """The whole leaf (of whole ``shape``) from every rank's shard ``t``
    (a collective over tp and ep: every rank of both groups calls it, in
    the same order)."""
    from deepspeed_tpu_torch import comm

    tp_dim, ep_dim = leaf_spec(name, shape, cfg, layout)
    t = t.contiguous()
    if tp_dim == "qkv":
        parts = comm.all_gather(t, "tp", tiled=False)
        whole = t.new_empty((shape[0],) + tuple(t.shape[1:]))
        for r in range(layout.tp):
            whole.index_copy_(0, _qkv_index(cfg, layout, r, t.device),
                              parts[r])
        t = whole
    elif tp_dim is not None:
        t = torch.cat(comm.all_gather(t, "tp", tiled=False).unbind(0),
                      dim=tp_dim)
    if ep_dim is not None:
        t = torch.cat(comm.all_gather(t.contiguous(), "ep",
                                      tiled=False).unbind(0), dim=ep_dim)
    return t


def gather_state_dict(state: Dict[str, torch.Tensor], cfg,
                      layout: ParallelLayout, keep: bool = True,
                      to_host: bool = False) -> Dict[str, torch.Tensor]:
    """Every leaf of this rank's ``state`` (named as the model's leaves)
    made whole (``gather_tensor``, leaf by leaf); ``keep=False`` drops
    them (a rank that writes nothing), ``to_host`` moves each to the host
    as it arrives."""
    shapes = whole_shapes(cfg)
    out = {}
    for k, v in state.items():
        w = gather_tensor(k, v, shapes[k], cfg, layout)
        if keep:
            out[k] = w.to("cpu", copy=True) if to_host else w
    return out


def replication(name: str, shape, cfg, layout: ParallelLayout) -> int:
    """How many ranks of the ``tp`` x ``ep`` slice hold the same copy of a
    leaf of whole ``shape``: its square counts once in the global gradient
    norm, so each copy's is weighted by the inverse."""
    tp_dim, ep_dim = leaf_spec(name, shape, cfg, layout)
    return (layout.tp if tp_dim is None else 1) * (
        layout.ep if ep_dim is None else 1)


# ---------------------------------------------------------------------------
# the collectives, as autograd functions
# ---------------------------------------------------------------------------
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x

    @staticmethod
    def backward(ctx, g):
        from deepspeed_tpu_torch import comm

        return comm.all_reduce(g.contiguous().clone(), ctx.axis), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        from deepspeed_tpu_torch import comm

        return comm.all_reduce(x.contiguous().clone(), "tp")

    @staticmethod
    def backward(ctx, g):
        return g


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: ``x`` forward, the gradient all-reduced over tp."""
    return _CopyTo.apply(x, "tp")


def copy_to_ep(x: torch.Tensor) -> torch.Tensor:
    """f over ep: the shared dispatch each ep rank reads its experts' slots
    from (the replicated-rows route); the gradient sums every rank's."""
    return _CopyTo.apply(x, "ep")


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: ``x`` all-reduced over tp, the gradient as it is."""
    return _ReduceFromTP.apply(x)


class _GatherLast(torch.autograd.Function):
    """All-gather over ``axis`` along ``dim``; the backward keeps this
    rank's slice (every rank holds the same loss of the gathered value)."""

    @staticmethod
    def forward(ctx, x, axis, dim, rank):
        from deepspeed_tpu_torch import comm

        ctx.axis, ctx.dim, ctx.rank, ctx.n = axis, dim, rank, x.shape[dim]
        parts = comm.all_gather(x.contiguous(), axis, tiled=False)
        return torch.cat(parts.unbind(0), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None, None


def gather_from_tp(x, layout: ParallelLayout, dim: int = -1):
    """The tp shards of ``x`` concatenated along ``dim``."""
    return _GatherLast.apply(x, "tp", dim % x.dim(), layout.tp_rank)


def gather_from_ep(x, layout: ParallelLayout):
    """Every ep rank's experts' ``[E/ep, C, M]`` outputs, ``[E, C, M]``."""
    return _GatherLast.apply(x, "ep", 0, layout.ep_rank)


class _AllToAllEP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim):
        from deepspeed_tpu_torch import comm

        ctx.dims = (split_dim, concat_dim)
        return comm.all_to_all_single(x, "ep", split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        from deepspeed_tpu_torch import comm

        split_dim, concat_dim = ctx.dims
        return (comm.all_to_all_single(g.contiguous(), "ep", concat_dim,
                                       split_dim), None, None)


def all_to_all_ep(x, split_dim: int, concat_dim: int):
    """``comm.all_to_all_single`` over ep, differentiable (the backward is
    the reverse exchange)."""
    return _AllToAllEP.apply(x, split_dim, concat_dim)


# ---------------------------------------------------------------------------
# the vocab-parallel embedding and cross entropy
# ---------------------------------------------------------------------------
def vocab_parallel_lookup(ids, weight, start: int, dtype):
    """JAX's ``_vocab_parallel_lookup`` (:331-367): each rank takes the
    rows of its vocabulary slice ``[start, start + V/tp)`` from its local
    table, zeroes the rows of ids it does not own, and one all-reduce over
    tp merges them (exactly one rank owns each id, so the sum is exact)."""
    n = weight.shape[0]
    local = ids - start
    valid = (local >= 0) & (local < n)
    rows = torch.nn.functional.embedding(torch.where(valid, local, 0),
                                         weight.to(dtype))
    rows = torch.where(valid[..., None], rows, torch.zeros((), dtype=dtype,
                                                           device=rows.device))
    return reduce_from_tp(rows)


def vocab_owned_target(logits, targets, start: int):
    """Each row's target logit from ``[n, V/tp]`` logit shards (this rank's
    vocabulary from ``start``), f32 ``[n]``: 0 where another rank owns the
    target, so a SUM over tp gives every row's."""
    local = targets - start
    mine = (local >= 0) & (local < logits.shape[-1])
    tgt = logits.gather(-1, torch.where(mine, local, 0)[:, None])[:, 0]
    return torch.where(mine, tgt.float(), 0.0)


def vocab_onehot_sub_(p, targets, start: int):
    """``p - onehot`` in place on a rank's ``[n, V/tp]`` slice from
    ``start``: the target's column changes only on the rank that owns
    it."""
    local = targets - start
    mine = (local >= 0) & (local < p.shape[-1])
    rows = torch.arange(p.shape[0], device=p.device)
    p[rows, torch.where(mine, local, 0)] -= mine.float()
    return p


class VocabParallelCrossEntropy(torch.autograd.Function):
    """The weighted mean nll of ``[N, V/tp]`` logit shards (compute dtype;
    this rank's vocabulary from ``start``), ``ops/cross_entropy``'s
    ``SoftmaxCrossEntropy`` over the whole vocabulary: the row max, the sum
    of exponentials under it and the target logit each all-reduced over tp
    (the fused head, which sees the logits a chunk at a time, rescales
    each chunk's sums to the global max after its last chunk instead). The
    backward is this rank's slice of ``scale * (softmax - onehot)`` in the
    logits' dtype."""

    @staticmethod
    def forward(ctx, logits, targets, weights, start):
        from deepspeed_tpu_torch import comm

        lf = logits.float()
        m = comm.all_reduce(lf.max(dim=-1).values.contiguous(), "tp",
                            comm.ReduceOp.MAX)
        sumexp = comm.all_reduce(torch.exp(lf - m[:, None]).sum(dim=-1),
                                 "tp")
        lse = torch.log(sumexp) + m
        tgt = comm.all_reduce(vocab_owned_target(logits, targets, start),
                              "tp")
        denom = torch.clamp(weights.sum(), min=1.0)
        ctx.save_for_backward(logits, targets, weights, lse, denom)
        ctx.start = start
        return ((lse - tgt) * weights).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, targets, weights, lse, denom = ctx.saved_tensors
        scale = (g * weights / denom).float()[:, None]
        p = vocab_onehot_sub_(torch.exp(logits.float() - lse[:, None]),
                              targets, ctx.start)
        return p.mul_(scale).to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, targets, weights, start: int):
    return VocabParallelCrossEntropy.apply(logits, targets, weights, start)


# ---------------------------------------------------------------------------
# JAX's rules, as tuples (held against the JAX package's in the tests)
# ---------------------------------------------------------------------------
def gpt_tp_rules(path: str, shape, sizes: Optional[Dict[str, int]] = None
                 ) -> Optional[Tuple]:
    """JAX ``gpt_tp_rules`` (``transformer_lm.py:1046-1076``) over JAX's
    paths and flax shapes (Dense kernels ``[in, out]``), as tuples: column
    parallel ``c_attn``/``c_fc``/``c_gate`` (last dim), row parallel
    ``c_proj`` (second to last), the vocab-parallel ``wte`` (dim 0) and
    untied head (last dim), and the experts' ``moe_param_spec``. With the
    axis ``sizes`` a dimension its axis does not divide, or an axis of size
    1, stays whole (JAX's ``ZeroShardingRules._tp_spec``), and an
    all-whole spec is None."""
    ndim = len(shape)

    def dim(i):
        spec = [None] * ndim
        spec[i] = "tp"
        return tuple(spec)

    if path.endswith(("attn/c_attn/kernel", "mlp/c_fc/kernel",
                      "mlp/c_gate/kernel", "attn/c_attn/bias",
                      "mlp/c_fc/bias", "mlp/c_gate/bias")):
        spec = dim(-1)
    elif path.endswith(("attn/c_proj/kernel", "mlp/c_proj/kernel")):
        spec = dim(-2)
    elif path.endswith("wte/embedding"):
        spec = dim(0)
    elif path.endswith(("lm_head/kernel", "lm_head")):
        spec = dim(-1)
    else:
        from deepspeed_tpu_torch.moe.layer import moe_param_spec

        spec = moe_param_spec(path, shape)
    if spec is None or sizes is None:
        return spec
    cleaned = tuple(a if a is not None and sizes.get(a, 1) > 1
                    and shape[i] % sizes[a] == 0 else None
                    for i, a in enumerate(spec))
    return None if all(a is None for a in cleaned) else cleaned
