"""Deterministic, seed+epoch-keyed, data-parallel sharded sample stream
(counterpart of ``deepspeed_tpu/data/streaming.py``, numpy only, kept as its
own copy: the same ``np.random.RandomState`` calls in the same order, so the
order is the JAX package's index for index).

Every rank can recompute which samples it owns from ``(seed, epoch)``
alone: each epoch is a fresh ``np.random.RandomState(seed + epoch)``
permutation (the ``DeepSpeedDataLoader`` idiom), and

* **sharding**: shard ``r`` of ``n`` owns global positions ``r, r+n,
  r+2n, ...`` of the epoch permutation (truncated to the common length
  ``n * (len // n)``), so shards are disjoint and equally sized;
* **mid-epoch resume**: ``state_dict`` carries a sample cursor, not just
  ``(epoch, seed)``, so a restore continues from the exact next document;
* **elastic re-stride**: the state also records the shard geometry
  (``num_shards``, the global ``epoch_offset`` this incarnation started
  striding from, and the ``epoch_boundary`` the epoch was started with).
  Loading it at another shard count assumes that the old ranks advanced
  in lockstep, so that the consumed set is the global-order prefix
  ``[epoch_offset, epoch_offset + cursor * N)``, and re-strides the
  remainder at the new count. Under sequence packing the ranks' cursors
  differ (a batch takes as many documents as fit): the engine keeps every
  rank's state, so a resume at the same count is exact on every rank, and
  only a resume at another count takes this arithmetic from rank 0's.

``reseed(offset)`` derives a fresh order (seed = base + offset) and
restarts the epoch traversal.
"""

from typing import Any, Dict

import numpy as np


class ShardedSampleStream:
    """Infinite iterator over a map-style dataset in a deterministic,
    sharded, per-epoch-shuffled order.

    ``next(stream)`` returns one sample and advances the cursor; epoch
    boundaries are internal (the order is rebuilt, ``epoch`` increments).
    """

    def __init__(self, dataset, *, shuffle: bool = True, seed: int = 0,
                 shard_rank: int = 0, num_shards: int = 1):
        if num_shards < 1 or not (0 <= shard_rank < num_shards):
            raise ValueError(
                f"invalid shard {shard_rank}/{num_shards}")
        if len(dataset) < num_shards:
            raise ValueError(
                f"dataset of {len(dataset)} samples cannot be split into "
                f"{num_shards} non-empty shards")
        self.dataset = dataset
        self.shuffle = shuffle
        self.seed = int(seed)
        self._base_seed = int(seed)
        self.shard_rank = shard_rank
        self.num_shards = num_shards
        self.epoch = 0
        self.cursor = 0  # samples already drawn by this shard this stride
        # where this incarnation's stride begins in the epoch's global
        # order (0 for a fresh epoch; the consumed frontier after an
        # elastic re-stride) and where the epoch ends (fixed by the
        # topology that STARTED the epoch — a resumed epoch must keep the
        # original truncation or samples appear/vanish at the tail)
        self.epoch_offset = 0
        self.epoch_boundary = self._default_boundary(num_shards)
        # bumped whenever the order changes out-of-band (reseed or
        # load_state_dict) so downstream stages can restart/flush
        self.order_version = 0
        self._order = None
        self._order_key = None

    def _default_boundary(self, num_shards: int) -> int:
        return num_shards * (len(self.dataset) // num_shards)

    @property
    def samples_per_epoch(self) -> int:
        """Per-shard epoch length (the common truncated length)."""
        return len(self.dataset) // self.num_shards

    def _full_order(self) -> np.ndarray:
        """The epoch's GLOBAL permutation — a pure function of
        (seed, epoch), identical on every rank of every topology."""
        key = (self.seed, self.epoch)
        if self._order_key != key:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                np.random.RandomState(self.seed + self.epoch).shuffle(order)
            self._order = order
            self._order_key = key
        return self._order

    def _next_global(self) -> int:
        """Global position of this shard's next sample: the stride base
        plus this rank's interleave offset."""
        return (self.epoch_offset + self.shard_rank
                + self.cursor * self.num_shards)

    def __iter__(self):
        return self

    def __next__(self) -> Any:
        g = self._next_global()
        if g >= self.epoch_boundary:
            self.epoch += 1
            self.cursor = 0
            self.epoch_offset = 0
            self.epoch_boundary = self._default_boundary(self.num_shards)
            g = self._next_global()
        sample = self.dataset[int(self._full_order()[g])]
        self.cursor += 1
        return sample

    # -- loader protocol (see runtime/dataloader.py) -----------------------
    def reseed(self, offset: int):
        """Fresh deterministic order: seed = base seed + offset, epoch
        traversal restarted."""
        self.seed = self._base_seed + int(offset)
        self.cursor = 0
        self.epoch_offset = 0
        self.epoch_boundary = self._default_boundary(self.num_shards)
        self.order_version += 1

    def state_dict(self) -> Dict[str, int]:
        return {"seed": self.seed, "epoch": self.epoch,
                "cursor": self.cursor,
                "num_shards": self.num_shards,
                "epoch_offset": self.epoch_offset,
                "epoch_boundary": self.epoch_boundary}

    def load_state_dict(self, state: Dict[str, int]):
        """Resume, re-striding when the state was saved under a different
        shard count. All ranks advance in lockstep (the engine steps them
        together), so a saved ``cursor`` under ``N`` shards means the
        global prefix ``[epoch_offset, epoch_offset + cursor * N)`` is
        consumed; the new topology strides the remainder. Legacy three-int
        states (no geometry) resume same-topology, bit-identical to the
        old behavior."""
        self.seed = int(state.get("seed", self.seed))
        self.epoch = int(state.get("epoch", self.epoch))
        cursor = int(state.get("cursor", self.cursor))
        saved_shards = state.get("num_shards")
        saved_offset = int(state.get("epoch_offset", 0))
        saved_boundary = state.get("epoch_boundary")
        if saved_shards is None or int(saved_shards) == self.num_shards:
            # same topology (or pre-geometry state): exact per-rank resume
            self.cursor = cursor
            self.epoch_offset = saved_offset
            self.epoch_boundary = int(
                saved_boundary if saved_boundary is not None
                else self._default_boundary(self.num_shards))
        else:
            # elastic re-stride: advance the global frontier past what the
            # old topology consumed, restart this rank's stride there
            saved_shards = int(saved_shards)
            self.cursor = 0
            self.epoch_offset = saved_offset + cursor * saved_shards
            self.epoch_boundary = int(
                saved_boundary if saved_boundary is not None
                else self._default_boundary(saved_shards))
        self.order_version += 1
