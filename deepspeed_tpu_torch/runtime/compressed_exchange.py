"""The explicit gradient exchanges of the data-parallel step: the deferred
bucketed exchange at an f32 or bf16 wire (with its hierarchical form), the
int8 EQuARX exchange (``communication_data_type: "int8"``) and the 1-bit
optimizers. Counterpart of ``deepspeed_tpu/runtime/engine.py``: the mode
selection (:298-340), ``_validate_compressed_config`` (:620-663, its
errors and warnings word for word), the state (:879-1034) and the
exchange and update core with its overflow guard (:1036-1252).

In every mode each rank keeps its OWN gradient (the gradient of its own
mean loss) as an f32 sum through the accumulation window, and the ranks
exchange once, at the boundary; the step's loss is the mean of the ranks'
losses. The sum is kept in the JAX engine's flat layout
(``module_inject/jax_params.py`` ``ExchangeLayout``: the leaves in
``jax.tree.flatten`` order, Dense kernels ``[in, out]``): the backward's
gradients are written into it through strided views, so that the buckets,
the quantisation blocks and the 1-bit chunks cover the same elements as
the JAX engine's, and the error-feedback buffers have the JAX shapes.

* ``deferred``: ``comm/bucketed.py``'s bucketed all-reduce (or the
  hierarchical one) of the sums, in place, divided by the world; then the
  global norm, the exact clip (every rank holds the whole mean: no
  collective), the cast to each parameter's dtype, and the inner optimizer
  (B4 for ``FusedAdam`` with ``tpu.use_pallas_optimizer``).
* ``int8``: ``quantized_all_reduce`` per leaf, or per bucket with
  ``bucket_mb``, with error feedback (a worker and a server residual per
  leaf or bucket, f32), then as ``deferred``.
* ``onebit``: the 1-bit optimizer (``runtime/fp16/onebit/``) steps on the
  rank's own gradient; ``gradient_clipping`` is ignored (with the JAX
  warning) and the grad norm is 0 unless ``tpu.compressed_grad_norm``
  adds the exact debug all-reduce.

Under fp16 the overflow flag is the MAX over dp of each rank's flag, and an
overflowing step leaves the parameters, the inner optimizer, the 1-bit
count and the error-feedback buffers as they were, decided on the device
(the collectives still run; their results are dropped). The 1-bit
branches (warm-up or compressed; 0/1 Adam's variance refresh) depend only
on the step count, which the host keeps: ``phase()`` names the next
step's branch and the engine captures one graph per phase.

Checkpoints: the optimizer's state by parameter name, as elsewhere, and
the error-feedback buffers as the JAX engine saves them, ``[k, ...]`` per
worker, gathered to the writing rank; a load copies each rank's row into
its live buffers (no graph is captured again). A load at another world is
refused: the buffers are per worker.
"""

import socket
import zlib
from typing import Any, Dict, List, Optional

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm.bucketed import (bucketed_all_reduce,
                                               bucketed_quantized_all_reduce,
                                               hierarchical_all_reduce,
                                               hierarchy_groups,
                                               plan_for_tree)
from deepspeed_tpu_torch.comm.compressed import (quantized_all_reduce,
                                                 server_shard_length)
from deepspeed_tpu_torch.module_inject.jax_params import exchange_layout
from deepspeed_tpu_torch.runtime.fp16.onebit.adam import _store
from deepspeed_tpu_torch.runtime.loss_scaler import has_overflow
from deepspeed_tpu_torch.runtime.optimizer import is_compressed_optimizer
from deepspeed_tpu_torch.runtime.utils import clip_factor, get_global_norm
from deepspeed_tpu_torch.utils.logging import log_dist, logger

AXIS = "dp"


# ---------------------------------------------------------------------------
# mode selection and validation (JAX engine :298-340, :620-663, :879-901)
# ---------------------------------------------------------------------------
def select_mode(config, dp_size: int) -> Optional[str]:
    """``"onebit"`` for a 1-bit optimizer, ``"int8"`` for
    ``communication_data_type: "int8"``, ``"deferred"`` for
    ``tpu.grad_exchange.deferred`` on a dp axis of more than one rank
    (``dp_size``), else None (the JAX engine's order). ``hierarchical:
    "on"`` without a mode raises."""
    gx = config.tpu.grad_exchange_config
    if is_compressed_optimizer(config.optimizer.type):
        return "onebit"
    if config.communication_data_type == "int8":
        return "int8"
    if gx.deferred and dp_size > 1:
        return "deferred"
    if gx.hierarchical == "on":
        raise ValueError(
            "tpu.grad_exchange.hierarchical: on requires the deferred "
            "exchange (tpu.grad_exchange.deferred: true on a dp>1 "
            "mesh)")
    return None


def validate_compressed_config(mode: str, config, topology) -> None:
    """The constraints the JAX engine puts on a compressed exchange."""
    max_stage = 1 if mode == "onebit" else 0
    if config.zero_config.stage > max_stage:
        raise ValueError(
            f"{mode} compressed gradient exchange requires ZeRO stage "
            f"<= {max_stage} (got {config.zero_config.stage}); the "
            "exchange needs the full gradient/momentum per worker — "
            "same limitation as the reference 1-bit optimizers")
    for ax in ("fsdp", "tp", "pp", "sp", "ep"):
        if topology.size(ax) > 1:
            raise ValueError(
                f"compressed gradient exchange runs over the dp axis "
                f"only; mesh axis {ax!r} has size {topology.size(ax)}")
    off = (config.zero_config.offload_optimizer or {}).get("device", "none")
    if off != "none":
        raise ValueError(
            f"{mode} compressed gradient exchange cannot combine with "
            "offload_optimizer (the host step bypasses the exchange)")
    if (config.tpu.grad_exchange_config.hierarchical != "off"
            and mode != "deferred"):
        raise ValueError(
            "tpu.grad_exchange.hierarchical requires the deferred "
            "bf16/fp32 exchange (grad_exchange.deferred: true); the "
            "onebit/int8 paths own their wire format end to end and "
            "carry error-feedback state the two-level exchange does "
            "not")
    if config.gradient_clipping and mode == "onebit":
        logger.warning(
            "gradient_clipping is ignored with the 1-bit optimizers: "
            "they exchange sign-compressed MOMENTUM, so the averaged "
            "gradient the clip would apply to never exists (divergence "
            "documented in docs/DIVERGENCES.md). The int8 "
            "communication_data_type path clips exactly.")
    if mode == "onebit" and config.zero_config.stage == 1:
        log_dist(
            "OnebitAdam with ZeRO stage 1: optimizer state stays "
            "replicated (the compressed exchange materializes the full "
            "momentum per worker)", ranks=[0])


def num_hosts() -> int:
    """The number of distinct hosts among the ranks (one all-gather of a
    hash of each rank's host name): on cards, the slices of the dp axis."""
    if not comm.is_initialized():
        return 1
    device = ("cuda" if comm.get_backend() == "nccl" else "cpu")
    mine = torch.tensor([zlib.crc32(socket.gethostname().encode())],
                        dtype=torch.int64,
                        device=device)
    out = torch.empty(comm.get_world_size(), dtype=torch.int64, device=device)
    torch.distributed.all_gather_into_tensor(out, mine)
    return len(set(out.tolist()))


def resolve_dcn_slices(gx, topology) -> int:
    """The slice count of the hierarchical exchange (1: flat).
    ``dcn_slices`` wins; otherwise the hosts of the dp axis."""
    if gx.hierarchical == "off":
        return 1
    w = topology.size("dp")
    n = gx.dcn_slices or num_hosts()
    if n <= 1:
        if gx.hierarchical == "on":
            raise ValueError(
                "tpu.grad_exchange.hierarchical: on, but the dp axis "
                "has no slice structure (single-slice mesh and "
                "dcn_slices unset) — use hierarchical: auto to fall "
                "back to the flat exchange, or set dcn_slices")
        return 1
    if w % n:
        raise ValueError(
            f"hierarchical exchange: {n} DCN slices do not divide the "
            f"dp axis of {w} ranks")
    return n


# ---------------------------------------------------------------------------
# the exchange and its state
# ---------------------------------------------------------------------------
class CompressedExchange:
    """The data-parallel state and step of a compressed ``mode`` over the
    dp axis: rank 0's parameters broadcast, the f32 gradient sum in the JAX
    layout, the bucket plan, the error feedback and the optimizer
    (``build(params, names, **kw)``). ``max_norm`` is the clip bound (an
    f32 device scalar) or None."""

    def __init__(self, mode: str, model, named, config, topology,
                 build, max_norm: Optional[torch.Tensor]):
        self.mode = mode
        self.topology = topology
        self.k = topology.size(AXIS)
        self.params = [p for _, p in named]
        self.names = [n for n, _ in named]
        device = self.params[0].device
        with torch.no_grad():
            for p in self.params:
                comm.broadcast(p.data, AXIS, root=0)
        self.layout = exchange_layout(
            [(n, p.shape) for n, p in named], model.config)
        gx = config.tpu.grad_exchange_config
        self.plan = None
        if mode == "deferred" or (mode == "int8" and gx.bucket_mb > 0):
            self.plan = plan_for_tree(self.layout.leaf_sizes, gx.bucket_mb)
        self.wire_dtype = (torch.float32 if gx.wire_dtype in ("fp32", "float32")
                           else torch.bfloat16)
        self.num_slices = (resolve_dcn_slices(gx, topology)
                           if mode == "deferred" else 1)
        self.dcn_block = gx.dcn_block
        self.max_norm = None if mode == "onebit" else max_norm
        self.debug_norm = bool(config.tpu.compressed_grad_norm)
        # the rank's own f32 gradient sum, in the JAX layout; each leaf a
        # view of it (end to end, so the exchanges run in place)
        self.acc = torch.zeros(self.layout.numel, device=device)
        self.leaves = [self.layout.leaf(self.acc, li)
                       for li in range(len(self.layout.leaves))]
        self.local_overflow = None
        self.worker_error: List[torch.Tensor] = []
        self.server_error: List[torch.Tensor] = []
        if mode == "onebit":
            self.inner = build(self.params, self.names,
                               compression_axis=AXIS,
                               compression_axis_size=self.k,
                               layout=self.layout)
            self.worker_error = self.inner.worker_error
            self.server_error = self.inner.server_error
        else:
            self.inner = build(self.params, self.names)
            if mode == "int8":
                sizes = (self.plan.bucket_sizes() if self.plan is not None
                         else self.layout.leaf_sizes)
                self.worker_error = [torch.zeros(n, device=device)
                                     for n in sizes]
                self.server_error = [
                    torch.zeros(server_shard_length(n, self.k), device=device)
                    for n in sizes]
        log_dist(f"gradient exchange: {mode}, dp {self.k}, "
                 f"{len(self.layout.leaves)} JAX leaves, "
                 + (f"{self.plan.num_buckets} buckets, " if self.plan else "")
                 + (f"wire {self.wire_dtype}, " if mode == "deferred" else "")
                 + (f"{self.num_slices} slices" if self.num_slices > 1
                    else "flat"), ranks=[0])

    # -- the host side ------------------------------------------------------
    def index_groups(self):
        """The sub-groups the step uses (``comm.warm_up`` makes them)."""
        if self.num_slices <= 1:
            return []
        ici, dcn = hierarchy_groups(self.k, self.num_slices)
        return [(AXIS, ici), (AXIS, dcn)]

    @property
    def norm_available(self) -> bool:
        """Whether the step computes the mean gradient's norm (int8 and
        deferred: from the exchanged mean; 1-bit: only with
        ``tpu.compressed_grad_norm``)."""
        return self.mode != "onebit" or self.debug_norm

    def phase(self) -> tuple:
        """The next step's branch: a static key of the captured step."""
        return self.inner.phase() if self.mode == "onebit" else ()

    # -- the device side ----------------------------------------------------
    def collect(self, add: bool):
        """Each parameter's ``.grad`` copied (or, with ``add``, added) into
        its place in the f32 sum, in the JAX layout; the grads cleared."""
        for i, p in enumerate(self.params):
            view = self.layout.view(self.acc, i)
            if p.grad is None:
                if not add:
                    view.zero_()
            elif add:
                view.add_(p.grad)
            else:
                view.copy_(p.grad)
            p.grad = None

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The mean of the ranks' losses (f32)."""
        return comm.all_reduce(loss.detach().float().clone(), AXIS).div_(self.k)

    def data_parallel_sum(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(x.detach().float().clone(), AXIS)

    def _exchange(self, skip):
        """The mean gradient over the ranks, in place in ``acc`` (the
        error feedback kept under ``skip``)."""
        if self.mode == "deferred":
            if self.num_slices > 1:
                hierarchical_all_reduce(
                    self.leaves, AXIS, self.num_slices, self.plan,
                    block=self.dcn_block, wire_dtype=self.wire_dtype,
                    mean=True, log_name="hierarchical_grad_exchange",
                    inplace=True)
            else:
                bucketed_all_reduce(
                    self.leaves, AXIS, self.plan, wire_dtype=self.wire_dtype,
                    mean=True, log_name="bucketed_grad_exchange",
                    inplace=True)
            return
        if self.plan is not None:
            _, we, se = bucketed_quantized_all_reduce(
                self.leaves, AXIS, self.plan,
                worker_errors=self.worker_error,
                server_errors=self.server_error, inplace=True)
            self.acc.div_(self.k)
        else:
            we, se = [], []
            for g, e, s in zip(self.leaves, self.worker_error,
                               self.server_error):
                r, e2, s2 = quantized_all_reduce(
                    g + e, AXIS, return_error=True, server_error=s)
                g.copy_(r).div_(self.k)
                we.append(e2)
                se.append(s2)
        _store(skip, list(zip(self.worker_error, we))
               + list(zip(self.server_error, se)))

    def update(self, phase: tuple, fp16: bool):
        """The exchange and the update from the f32 sums (already divided
        by the loss scale). Returns ``(norm, overflow)``, overflow None
        without fp16."""
        overflow = None
        if fp16:
            self.local_overflow = has_overflow([self.acc])
            overflow = comm.all_reduce(self.local_overflow.float(), AXIS,
                                       comm.ReduceOp.MAX) > 0
        if self.mode == "onebit":
            if self.debug_norm:
                mean = comm.all_reduce(self.acc.clone(), AXIS,
                                       log_name="compressed_grad_norm")
                norm = get_global_norm([mean.div_(self.k)])
            else:
                norm = torch.zeros((), device=self.acc.device)
            self.inner.apply(self.acc, phase[0], skip=overflow)
            return norm, overflow
        self._exchange(overflow)
        norm = get_global_norm(self.leaves)
        if self.max_norm is not None:
            self.acc.mul_(clip_factor(norm, self.max_norm))
        grads = [torch.empty_like(p).copy_(self.layout.view(self.acc, i))
                 for i, p in enumerate(self.params)]
        self.inner.apply(grads, skip=overflow)
        return norm, overflow

    # -- checkpoints ----------------------------------------------------------
    def _keys(self) -> List[str]:
        if self.mode == "int8" and self.plan is not None:
            return [f"bucket{b}" for b in range(self.plan.num_buckets)]
        return [path for path, _ in self.layout.leaves]

    def _saved_shape(self, j: int, buf: torch.Tensor):
        """A buffer's JAX shape (per worker): a per-leaf int8 residual has
        its leaf's shape; the others are flat."""
        if self.mode == "int8" and self.plan is None and \
                buf.numel() == self.layout.leaf_sizes[j]:
            return self.layout.leaves[j][1]
        return (buf.numel(),)

    def state_dict(self, keep: bool = True, to_host: bool = False
                   ) -> Dict[str, Any]:
        """The optimizer's state by name and the error feedback gathered
        over dp as ``[k, ...]`` per buffer (a collective: every rank calls
        it; ``keep=False`` drops the result)."""
        opt = self.inner.state_dict()
        if to_host:
            opt = {"count": opt["count"],
                   "state": {n: {k: v.to("cpu", copy=True)
                                 for k, v in s.items()}
                             for n, s in opt["state"].items()}}
        out = {"optimizer": opt, "grad_exchange": {
            "mode": self.mode, "world": self.k}}
        for field in ("worker_error", "server_error"):
            saved = {}
            for j, (key, buf) in enumerate(zip(self._keys(),
                                               getattr(self, field))):
                rows = comm.all_gather(buf, AXIS)
                if keep:
                    rows = rows.view((self.k,) + tuple(
                        self._saved_shape(j, buf) if field == "worker_error"
                        else (buf.numel(),)))
                    saved[key] = (rows.to("cpu", copy=True) if to_host
                                  else rows.clone())
            if self.worker_error:
                out["grad_exchange"][field] = saved
        return out if keep else None

    @torch.no_grad()
    def load_state(self, sd: Dict[str, Any]):
        """Restore ``state_dict()``'s result (or
        ``compressed_state_from_jax``'s, the rows of this rank as lists) in
        place. The error feedback of another world is refused; an int8 tag
        without server residuals starts them at 0 (the JAX migration of
        tags saved before them)."""
        from deepspeed_tpu_torch.runtime.reshard import ReshardError

        self.inner.load_state_dict(sd["optimizer"])
        gx = sd.get("grad_exchange")
        if not self.worker_error:
            return
        if gx is None:
            # a tag of an engine without this exchange: a cold start
            log_dist("checkpoint without gradient-exchange state: the error "
                     "feedback starts at 0", ranks=[0])
            for b in self.worker_error + self.server_error:
                b.zero_()
            return
        saved_world = gx.get("world", self.k)
        if saved_world != self.k:
            raise ReshardError(
                f"the {self.mode} gradient exchange's error feedback was "
                f"saved by {saved_world} workers and this engine has "
                f"{self.k}: each worker's residuals are its own and do not "
                "reshard (the JAX engine's [k, ...] buffers take the dp "
                "size they were saved at)")
        rank = self.topology.axis_index(AXIS)
        for field in ("worker_error", "server_error"):
            bufs = getattr(self, field)
            src = gx.get(field)
            if src is None:
                if field == "server_error" and self.mode == "int8":
                    for b in bufs:
                        b.zero_()
                    continue
                raise KeyError(f"grad_exchange state without {field}")
            rows = ([src[key][rank] for key in self._keys()]
                    if isinstance(src, dict) else list(src))
            if len(rows) != len(bufs):
                raise ValueError(f"grad_exchange {field}: {len(rows)} "
                                 f"buffers, want {len(bufs)}")
            for dst, row in zip(bufs, rows):
                if row.numel() != dst.numel():
                    raise ValueError(
                        f"grad_exchange {field}: {row.numel()} elements, "
                        f"want {dst.numel()}")
                dst.copy_(row.reshape(-1))

    def zero_accumulators(self):
        self.acc.zero_()
