"""Top-k gating, dispatch and combine for mixture of experts (counterpart of
``deepspeed_tpu/moe/sharded_moe.py``: ``static_capacity`` :38,
``top1_gating`` :56, ``top2_gating`` :135, ``topk_gating`` :192,
``dispatch_tokens`` :211 and ``combine_tokens`` :217).

The same arguments, capacity rules, auxiliary losses, location cumsums,
renormalisation and argument refusals as the JAX functions, with one change
of design: the random draws come in as tensors, not as an rng. Where the
JAX function splits its key, the caller passes what that key drew:

* ``top1_gating``: ``gumbel`` ([T, E], the RSample noise) and ``uniform``
  ([T, E], the random token selection's priorities);
* ``top2_gating``: ``gumbel`` ([T, E], the second expert's noise).

``None`` means no noise, as ``rng=None`` does in JAX. The caller draws them
up front (the training engine from its gating generator), so a full-remat
recompute routes exactly as its forward did, a captured step draws fresh
noise at every replay, and a test can pass the numbers ``jax.random`` drew.

Routing is kept in index form (``Routing``: each token's expert, slot and
weight for each of its k choices), from which the JAX package's dense
``[T, E, C]`` combine weights and dispatch mask are built on demand
(``GatingOutput.combine_weights`` / ``dispatch_mask``). ``dispatch_tokens``
and ``combine_tokens`` are the dense one-hot products of the JAX package
(the plain version); ``dispatch_by_index`` and ``combine_by_index`` compute
the same from the indices: a one-hot row copies a token exactly, and the
combine sums, in f32, the same <= k non-zero terms. Their shapes are fixed
by (T, E, C), so they capture: a dropped choice is dispatched to a spare
row past the last expert's, which the experts never see, and combined from
row 0 with weight 0.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch


def static_capacity(num_tokens: int, num_experts: int, capacity_factor: float,
                    min_capacity: int) -> int:
    """Per-expert capacity from the static token count (JAX :38)."""
    capacity = int(np.ceil((num_tokens / num_experts) * capacity_factor))
    capacity = max(capacity, min_capacity)
    return min(capacity, num_tokens)


@dataclasses.dataclass
class Routing:
    """Each token's k choices: ``experts`` [k, T] (long), ``locations``
    [k, T] (the slot in the expert's capacity, 0 where dropped), ``kept``
    [k, T] (bool) and ``weights`` [k, T] (f32, 0 where dropped; the
    gradient reaches the gate through them)."""

    experts: torch.Tensor
    locations: torch.Tensor
    kept: torch.Tensor
    weights: torch.Tensor
    num_experts: int
    capacity: int

    def slots(self, spare: Optional[int] = None) -> torch.Tensor:
        """[k, T] row of each choice in the flat ``[E * C, M]`` expert
        buffer; a dropped choice gets row ``spare`` (default ``E * C``,
        one past the last)."""
        spare = self.num_experts * self.capacity if spare is None else spare
        return torch.where(self.kept,
                           self.experts * self.capacity + self.locations,
                           torch.full_like(self.experts, spare))

    def combine_weights(self) -> torch.Tensor:
        """The dense [T, E, C] f32 combine weights (JAX's ``combine``)."""
        T = self.experts.shape[1]
        E, C = self.num_experts, self.capacity
        out = self.weights.new_zeros((T, E * C + 1))
        out = out.scatter_add(1, self.slots().t(), self.weights.t())
        return out[:, :E * C].view(T, E, C)

    def dispatch_mask(self) -> torch.Tensor:
        """The dense [T, E, C] bool dispatch mask (JAX: ``combine > 0``)."""
        return self.combine_weights() > 0


@dataclasses.dataclass
class GatingOutput:
    """JAX's ``GatingOutput`` (``l_aux``, ``exp_counts`` [E] int32, and the
    dense ``combine_weights`` / ``dispatch_mask``), the dense tensors made
    from ``routing`` when asked for."""

    l_aux: torch.Tensor
    exp_counts: torch.Tensor
    routing: Routing

    @property
    def combine_weights(self) -> torch.Tensor:
        return self.routing.combine_weights()

    @property
    def dispatch_mask(self) -> torch.Tensor:
        return self.routing.dispatch_mask()


def _one_hot(idx, n):
    # F.one_hot may read the indices' range back to the host: a compare
    # keeps the gating free of syncs, so it captures
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(
        torch.int32)


def _gather(t, idx):
    return t.gather(1, idx[:, None])[:, 0]


def top1_gating(logits: torch.Tensor, capacity_factor: float = 1.0,
                min_capacity: int = 4, gumbel: Optional[torch.Tensor] = None,
                uniform: Optional[torch.Tensor] = None,
                noisy_gate_policy: Optional[str] = None,
                drop_tokens: bool = True, use_rts: bool = True,
                used_token: Optional[torch.Tensor] = None) -> GatingOutput:
    """Top-1 (Switch) gating (JAX :56). ``gumbel`` is the RSample noise
    (used under ``noisy_gate_policy="RSample"``), ``uniform`` the random
    token selection's priorities (used under ``use_rts``)."""
    logits = logits.float()
    num_tokens, num_experts = logits.shape
    gates = torch.softmax(logits, dim=-1)
    capacity = (static_capacity(num_tokens, num_experts, capacity_factor,
                                min_capacity) if drop_tokens else num_tokens)
    if noisy_gate_policy == "RSample" and gumbel is not None:
        indices1 = torch.argmax(logits + gumbel, dim=-1)
    else:
        indices1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(indices1, num_experts)
    if used_token is not None:
        mask1 = mask1 * used_token[:, None].to(mask1.dtype)
    exp_counts = mask1.sum(0).to(torch.int32)
    # load-balance loss (JAX :93): mean gate probability . routed share
    me = gates.mean(0)
    ce = mask1.float().mean(0)
    l_aux = (me * ce).sum() * num_experts
    if use_rts and uniform is not None:
        # random token selection: each expert keeps its `capacity` routed
        # tokens of highest priority (the rest of the top-k are unrouted
        # tokens of priority 0, which the mask zeroes again)
        priority = mask1.float() * uniform
        top_idx = torch.topk(priority.t(), capacity, dim=1).indices  # [E, C]
        keep = torch.zeros((num_experts, num_tokens), dtype=mask1.dtype,
                           device=logits.device)
        keep.scatter_(1, top_idx, 1)
        mask1 = mask1 * keep.t()
        locations1 = mask1.cumsum(0) - 1
    else:
        locations1 = mask1.cumsum(0) - 1
        mask1 = mask1 * (locations1 < capacity).to(mask1.dtype)
    kept = mask1.sum(-1) > 0
    loc = (locations1 * mask1).sum(-1)
    weight = _gather(gates, indices1) * kept.float()
    routing = Routing(indices1[None], loc[None].long(), kept[None],
                      weight[None], num_experts, capacity)
    return GatingOutput(l_aux, exp_counts, routing)


def top2_gating(logits: torch.Tensor, capacity_factor: float = 1.0,
                min_capacity: int = 4,
                gumbel: Optional[torch.Tensor] = None) -> GatingOutput:
    """Top-2 (GShard) gating (JAX :135): the second expert by gumbel-max
    over the other logits, the two weights renormalised over the kept
    choices."""
    logits = logits.float()
    num_tokens, num_experts = logits.shape
    gates = torch.softmax(logits, dim=-1)
    capacity = static_capacity(num_tokens, num_experts, 2.0 * capacity_factor,
                               min_capacity)
    indices1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(indices1, num_experts)
    noisy = logits + gumbel if gumbel is not None else logits
    except1 = noisy.masked_fill(mask1.bool(), float("-inf"))
    indices2 = torch.argmax(except1, dim=-1)
    mask2 = _one_hot(indices2, num_experts)
    locations1 = mask1.cumsum(0) - 1
    locations2 = mask2.cumsum(0) - 1 + mask1.sum(0, keepdim=True)
    exp_counts = mask1.sum(0).to(torch.int32)
    me = gates.mean(0)
    ce = mask1.float().mean(0)
    l_aux = (me * ce).mean() * num_experts * num_experts
    mask1 = mask1 * (locations1 < capacity).to(mask1.dtype)
    mask2 = mask2 * (locations2 < capacity).to(mask2.dtype)
    kept1, kept2 = mask1.sum(-1) > 0, mask2.sum(-1) > 0
    loc1 = (locations1 * mask1).sum(-1)
    loc2 = (locations2 * mask2).sum(-1)
    g1 = _gather(gates, indices1) * kept1.float()
    g2 = _gather(gates, indices2) * kept2.float()
    denom = torch.clamp(g1 + g2, min=torch.finfo(torch.float32).eps)
    routing = Routing(torch.stack([indices1, indices2]),
                      torch.stack([loc1, loc2]).long(),
                      torch.stack([kept1, kept2]),
                      torch.stack([g1 / denom, g2 / denom]),
                      num_experts, capacity)
    return GatingOutput(l_aux, exp_counts, routing)


def topk_gating(logits: torch.Tensor, k: int, **kwargs) -> GatingOutput:
    """``top1_gating`` or ``top2_gating`` (JAX :192); the top-1-only options
    away from their defaults are refused under top-2."""
    if k == 1:
        return top1_gating(logits, **kwargs)
    if k == 2:
        unsupported = {"noisy_gate_policy": None, "drop_tokens": True,
                       "use_rts": True, "used_token": None, "uniform": None}
        for name, default in unsupported.items():
            if name in kwargs and kwargs.pop(name) is not default:
                raise ValueError(
                    f"top-2 gating does not support {name} "
                    "(top-1-only option, see reference sharded_moe.py:278)")
        return top2_gating(logits, **kwargs)
    raise ValueError(f"only top-1 and top-2 gating are supported, got k={k}")


def dispatch_tokens(dispatch_mask: torch.Tensor, x: torch.Tensor
                    ) -> torch.Tensor:
    """[T, E, C] bool x [T, M] -> [E, C, M] (JAX :211), one product in the
    compute dtype."""
    return torch.einsum("tec,tm->ecm", dispatch_mask.to(x.dtype), x)


def combine_tokens(combine_weights: torch.Tensor, expert_out: torch.Tensor,
                   dtype=None) -> torch.Tensor:
    """[T, E, C] x [E, C, M] -> [T, M] in the weights' dtype (f32; JAX
    :217), cast to ``dtype``."""
    y = torch.einsum("tec,ecm->tm", combine_weights,
                     expert_out.to(combine_weights.dtype))
    return y.to(dtype) if dtype is not None else y


def dispatch_by_index(routing: Routing, x: torch.Tensor) -> torch.Tensor:
    """``dispatch_tokens`` from the indices: each (token, choice) row of
    positive weight (JAX's ``dispatch = combine > 0``) copied into its slot
    of a zeroed [E * C + 1, M] buffer, returned as [E, C, M] (the spare
    row, where the other choices land, cut off)."""
    k, T = routing.experts.shape
    E, C = routing.num_experts, routing.capacity
    sent = dataclasses.replace(routing,
                               kept=routing.kept & (routing.weights > 0))
    src = x.unsqueeze(0).expand(k, T, x.shape[-1]).reshape(k * T, -1)
    buf = x.new_zeros((E * C + 1, x.shape[-1]))
    buf = buf.index_copy(0, sent.slots().reshape(-1), src)
    return buf[:E * C].view(E, C, -1)


def combine_by_index(routing: Routing, expert_out: torch.Tensor,
                     dtype=None) -> torch.Tensor:
    """``combine_tokens`` from the indices: each token's f32 sum of its
    <= k weighted expert rows (a dropped choice reads row 0 with weight
    0)."""
    E, C, M = expert_out.shape
    picked = expert_out.reshape(E * C, M)[routing.slots(spare=0)].float()
    y = (routing.weights[..., None] * picked).sum(0)      # [T, M]
    return y.to(dtype) if dtype is not None else y
