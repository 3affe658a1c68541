"""Disaggregated serving: prefill/decode split with an exact KV hand-off
(counterpart of ``deepspeed_tpu/serving/disagg.py``, the whole module).

Chunked prompt prefill is compute-bound (large GEMMs over whole blocks),
while the continuous-batching token loop is memory-bound (one ``[slots, 1]``
step per token over the weights and the KV cache). A replica serving both
interleaves them, so every admission prefill stalls every decoding lane's
next token. This module splits the two phases over the scheduler's own
machinery:

* :class:`PrefillWorker` -- a prefill-role replica: runs the same chunked
  prefill the scheduler's admission runs (``engine._chunked_prefill``, the
  same left-pad bucketing, the same graphs), and emits a :class:`KVHandoff`
  -- the first greedy token and the one-row decode cache, sized in bytes as
  it would cross a wire.
* :class:`KVHandoff` -- the transfer artifact. The scheduler's ``kv_handoff``
  admission splices its cache into a lane (``KVCache.splice``) as it does a
  local prefill, and greedy decode is a pure function of (weights, cache,
  last token), so a decode replica continuing from a handed cache emits the
  tokens of one that prefilled locally.
* :class:`DisaggServer` -- in-process composition of N prefill workers and
  one decode scheduler: routes each prompt to a worker (hash-affine through
  ``FleetCoordinator.place_prefill`` when a coordinator is wired,
  round-robin otherwise), accounts every hand-off as a ``serve.kv_transfer``
  event and queues the request on the decode scheduler with the hand-off.

**The hand-off owns its cache.** A prefill leaves its result in the
engine's batch-1 cache, which the next prefill overwrites in place (the
graphs read its buffers). A JAX cache is an immutable tree; here
:meth:`PrefillWorker.prefill` copies the cache (``KVCache.clone``), so
hand-offs queued before ``run`` do not all alias the last prefill, and
``nbytes`` counts that copy.

Over a tensor-parallel engine every rank builds the same server and calls
``submit`` and ``run`` alike: rank 0 places each prompt, every rank
prefills it and hands off its own KV heads in process (``handoff_bytes``
counts this rank's, 1/tp of one card's), and only rank 0 accounts the
transfer on the bus.

The int8 KV cache (``{"kv_cache": "int8"}``) shrinks both the resident
lane bytes (:func:`lane_kv_bytes`) and the hand-off payload by ~2x against
bf16. Producer and consumer must agree on ``prompt_bucket`` (the cache
bakes in the pad offset; :class:`DisaggServer` checks it) and on the cache
geometry (``KVCache.splice`` fails loudly on another one).
"""

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import \
    ring_engaged
# the bytes a cross-host hand-off ships: every buffer of a KVCache, int8
# codes and their f32 scales included
from deepspeed_tpu_torch.serving.prefix_cache import \
    _tree_nbytes as tree_nbytes
from deepspeed_tpu_torch.telemetry.bus import KIND_SERVE_KV_TRANSFER, publish

__all__ = ["KVHandoff", "PrefillWorker", "DisaggServer", "lane_kv_bytes",
           "tree_nbytes"]


def lane_kv_bytes(model, slots: int = 1) -> Dict[str, int]:
    """Per-lane decode KV-cache bytes of ``model`` (a GPT; an engine's
    ``module``, under tensor parallelism the rank's KV heads), from a cache
    built on the ``meta`` device: nothing is allocated.

    ``resident_bytes`` is what the cache stores (int8 codes plus f32 scales
    under ``kv_cache_dtype="int8"``), ``unquantized_bytes`` the same cache
    with keys and values in the compute dtype and no scales, for ONE lane.
    The keys, values and scales are JAX's bytes exactly; the bookkeeping is
    not: the port keeps one ``valid`` [S] and one ``index`` per row for all
    layers (a ring adds ``slot_pos`` [S], learned positions a ``position``),
    where flax keeps ``valid`` and ``index`` in every layer."""
    from deepspeed_tpu_torch.models.transformer_lm import kv_cache

    # a tensor-parallel rank's cache holds its KV heads
    mcfg = getattr(model, "cache_config", model.config)
    cache = kv_cache(mcfg, int(slots), torch.device("meta"))
    compute = torch.finfo(mcfg.dtype).bits // 8
    kv = [*cache.key, *cache.value]
    side = tree_nbytes(kv) + tree_nbytes([*(cache.key_scale or []),
                                          *(cache.value_scale or [])])
    resident = tree_nbytes(cache)
    unquant = resident - side + sum(t.numel() * compute for t in kv)
    return {"resident_bytes": int(resident // slots),
            "unquantized_bytes": int(unquant // slots)}


@dataclass
class KVHandoff:
    """One prefill replica's output for one prompt: everything a decode
    replica needs to continue exactly (greedy decode is a pure function of
    weights, cache and last token)."""
    request_id: Any
    first_token: int
    cache: Any            # a one-row KVCache this hand-off owns
    nbytes: int           # payload size as shipped (tree_nbytes)
    prompt_bucket: int    # the producer's bucket: the consumer's must match
    prefill_s: float = 0.0

    def as_submit_arg(self):
        """The ``kv_handoff=`` value for ``scheduler.submit``."""
        return (self.first_token, self.cache)


class PrefillWorker:
    """A prefill-role replica over one engine: the exact chunked prompt
    prefill -> :class:`KVHandoff`. Greedy only: the first token must be the
    one the decode replica would have picked."""

    def __init__(self, engine, prompt_bucket: Optional[int] = None,
                 replica: int = 0):
        self.engine = engine
        self.replica = int(replica)
        ring = ring_engaged(engine.module.config)
        if prompt_bucket is None:
            prompt_bucket = ring[2] if ring is not None else 64
        if ring is not None and prompt_bucket % ring[2] != 0:
            raise ValueError(
                f"prompt_bucket {prompt_bucket} must be a multiple of "
                f"the ring layout block {ring[2]} (same rule as the "
                "decode scheduler — the cache bakes in the pad offset)")
        self.prompt_bucket = int(prompt_bucket)
        self.prefills = 0
        self.kv_bytes = 0

    def _bucketed(self, n: int) -> int:
        b = self.prompt_bucket
        return ((n + b - 1) // b) * b

    def prefill(self, prompt: Sequence[int], request_id=None) -> KVHandoff:
        """Run one prompt's exact chunked prefill; returns the hand-off,
        which owns a copy of the engine's batch-1 cache."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("an empty prompt cannot seed generation")
        eng = self.engine
        t0 = time.monotonic()
        Lp = self._bucketed(len(prompt))
        ids = np.zeros((1, Lp), np.int64)
        mask = np.zeros((1, Lp), bool)
        ids[0, Lp - len(prompt):] = prompt
        mask[0, Lp - len(prompt):] = True
        with torch.inference_mode():
            logits, cache = eng._chunked_prefill(
                torch.from_numpy(ids).to(eng.device),
                torch.from_numpy(mask).to(eng.device))
            first = int(eng._next_token(logits, False)[0])
            cache = cache.clone()
        nbytes = tree_nbytes(cache)
        self.prefills += 1
        self.kv_bytes += nbytes
        return KVHandoff(request_id=request_id, first_token=first,
                         cache=cache, nbytes=nbytes,
                         prompt_bucket=self.prompt_bucket,
                         prefill_s=time.monotonic() - t0)

    def stats(self) -> Dict[str, Any]:
        return {"replica": self.replica, "prefills": self.prefills,
                "kv_bytes": self.kv_bytes}


class DisaggServer:
    """In-process prefill/decode disaggregation: N prefill workers feed one
    decode scheduler through :class:`KVHandoff`s.

    ``submit`` runs the prefill synchronously on the chosen worker, accounts
    the hand-off (``serve.kv_transfer``) and queues the request on the
    decode scheduler with the cache attached, so the decode loop never runs
    a prompt prefill. ``run`` drives the decode scheduler.

    ``coordinator`` (optional, a role-aware ``FleetCoordinator``) takes over
    prefill placement (hash-affine) and transfer accounting; without one,
    placement is round-robin and events publish directly.
    """

    def __init__(self, scheduler, prefill_workers: Sequence[PrefillWorker],
                 coordinator=None):
        if not prefill_workers:
            raise ValueError("DisaggServer needs >= 1 PrefillWorker")
        self.scheduler = scheduler
        self.workers = list(prefill_workers)
        self.coordinator = coordinator
        for w in self.workers:
            if w.prompt_bucket != scheduler.prompt_bucket:
                raise ValueError(
                    f"prefill worker bucket {w.prompt_bucket} != decode "
                    f"scheduler bucket {scheduler.prompt_bucket}: the "
                    "handed cache bakes in the pad offset, so producer "
                    "and consumer must bucket identically")
        self._rr = 0
        self.handoffs = 0
        self.handoff_bytes = 0

    def _pick_worker(self, prompt) -> int:
        if self.coordinator is not None:
            # in-process workers have no transport to heartbeat through,
            # and the coordinator's silence schedule would mark them down
            # during a long prefill: a worker called directly is alive, so
            # vouch for it here (out-of-process replicas live or die by
            # their pipes)
            for w in self.workers:
                self.coordinator.health.heartbeat(w.replica)
            replica, _how = self.coordinator.place_prefill(prompt)
            for i, w in enumerate(self.workers):
                if w.replica == replica:
                    return i
            raise ValueError(
                f"coordinator placed prefill on replica {replica}, but "
                f"no PrefillWorker here carries that replica index")
        i = self._rr
        self._rr = (self._rr + 1) % len(self.workers)
        return i

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               **submit_kw) -> int:
        """Prefill on a worker, hand off, queue on the decode scheduler.
        Returns the decode scheduler's request id."""
        sched = self.scheduler
        # over a serving group rank 0 places the prefill and every rank
        # runs it, handing off its own KV heads
        idx = sched.decide(self._pick_worker(prompt) if sched.leader
                           else None)
        worker = self.workers[idx]
        h = worker.prefill(prompt)
        self.handoffs += 1
        self.handoff_bytes += h.nbytes
        rid = sched.submit(prompt, max_new_tokens=max_new_tokens,
                           kv_handoff=h.as_submit_arg(), **submit_kw)
        if not sched.leader:
            return rid
        if self.coordinator is not None:
            self.coordinator.record_kv_transfer(
                rid, from_replica=worker.replica, to_replica=-1,
                nbytes=h.nbytes, transfer_s=h.prefill_s)
        else:
            publish(KIND_SERVE_KV_TRANSFER, request_id=rid,
                    from_replica=worker.replica, to_replica=-1,
                    bytes=h.nbytes, transfers_total=self.handoffs,
                    bytes_total=self.handoff_bytes)
        return rid

    def run(self, poll_fn=None):
        return self.scheduler.run(poll_fn)

    def stats(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "handoffs": self.handoffs,
            "handoff_bytes": self.handoff_bytes,
            "workers": [w.stats() for w in self.workers],
            "frontdoor": self.scheduler.frontdoor_stats(),
        }
        if self.coordinator is not None:
            out["fleet"] = self.coordinator.stats()
        return out
