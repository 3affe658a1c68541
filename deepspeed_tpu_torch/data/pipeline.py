"""PackedDataPipeline (counterpart of ``deepspeed_tpu/data/pipeline.py``,
numpy only, kept as its own copy): the loader-protocol object tying the
sharded sample stream and the sequence packer into an infinite batch
iterator.

The engine's ``deepspeed_io`` builds it in place of ``DeepSpeedDataLoader``
when the ``data_pipeline`` block is enabled. It speaks the loader protocol
the engine and its checkpoints rely on (``state_dict``/``load_state_dict``/
``reseed``/``order_version``/``seed``/``batch_size``), and its state is
the JAX pipeline's: a state saved by either loads into the other.

Curriculum hook: ``seqlen_fn`` (wired by the engine to the
``CurriculumScheduler``'s quantized difficulty) is polled once per batch,
at its start. A changed target seq-len drops nothing: pending documents
are re-queued into a packer of the new shape, so the number of distinct
batch shapes (and of captured step graphs) stays bounded by the
schedule's distinct values, not by the data.
"""

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from deepspeed_tpu_torch.data.packing import SequencePacker
from deepspeed_tpu_torch.data.streaming import ShardedSampleStream


class PackedDataPipeline:
    """Infinite iterator of packed ``[B, S]`` batch dicts.

    With ``pack_sequences=False`` it degrades to fixed-shape collation:
    every batch is ``batch_size`` consecutive stream samples stacked (and
    right-padded/truncated to ``seq_length``), with segment/position
    fields still emitted so the model-side masking stays uniform.
    """

    def __init__(self, dataset, *, batch_size: int, seq_length: int,
                 pack_sequences: bool = True, pad_token_id: int = 0,
                 shuffle: bool = True, seed: int = 0, shard_rank: int = 0,
                 num_shards: int = 1,
                 seqlen_fn: Optional[Callable[[], int]] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if seq_length < 2:
            raise ValueError(f"seq_length must be >= 2, got {seq_length}")
        self.batch_size = batch_size
        self.seq_length = seq_length
        self.pack_sequences = pack_sequences
        self.pad_token_id = pad_token_id
        self.seqlen_fn = seqlen_fn
        self.stream = ShardedSampleStream(
            dataset, shuffle=shuffle, seed=seed,
            shard_rank=shard_rank, num_shards=num_shards)
        self._packer = SequencePacker(batch_size, seq_length,
                                      pad_id=pad_token_id)
        # batches finished early by a seq-len change, delivered before any
        # new packing happens
        self._ready: List[Dict[str, np.ndarray]] = []
        self._last_order_version = self.stream.order_version

    # -- loader protocol ---------------------------------------------------
    @property
    def order_version(self) -> int:
        return self.stream.order_version

    @property
    def seed(self) -> int:
        return self.stream.seed

    def reseed(self, offset: int):
        """Fresh sample order (the JAX sentinel's rollback path), and the
        pending half-packed rows are dropped."""
        self._packer.reset()
        self._ready = []
        self.stream.reseed(offset)
        self._last_order_version = self.stream.order_version

    def state_dict(self) -> Dict[str, Any]:
        return {
            "stream": self.stream.state_dict(),
            "packer": self._packer.state_dict(),
            "ready": [
                {k: v.tolist() for k, v in b.items()} for b in self._ready
            ],
        }

    def load_state_dict(self, state: Dict[str, Any]):
        saved_shards = (state.get("stream") or {}).get("num_shards")
        self.stream.load_state_dict(state["stream"])
        if (saved_shards is not None
                and int(saved_shards) != self.stream.num_shards):
            # elastic re-stride: the stream resumed at the new geometry
            # (see ShardedSampleStream.load_state_dict). The half-packed
            # rows and ready batches belong to ONE old-rank's pipeline;
            # every new rank loads the same state, so exactly one of them
            # (rank 0) may carry the pending work forward — anywhere else
            # it would be delivered num_shards times
            if self.stream.shard_rank == 0:
                self._packer.load_state_dict(state["packer"])
                self._ready = [
                    {k: np.asarray(v, dtype=np.int32) for k, v in b.items()}
                    for b in state.get("ready", [])
                ]
            else:
                self._packer.reset()
                self._ready = []
        else:
            self._packer.load_state_dict(state["packer"])
            self._ready = [
                {k: np.asarray(v, dtype=np.int32) for k, v in b.items()}
                for b in state.get("ready", [])
            ]
        self._last_order_version = self.stream.order_version

    # -- iteration ---------------------------------------------------------
    def _sync_order_version(self):
        # the stream was reseeded/restored out-of-band (e.g. via a direct
        # handle): half-packed state belongs to the dead order
        if self.stream.order_version != self._last_order_version:
            self._packer.reset()
            self._ready = []
            self._last_order_version = self.stream.order_version

    def _apply_seqlen(self):
        if self.seqlen_fn is None:
            return
        target = int(self.seqlen_fn())
        target = max(2, min(self.seq_length, target))
        if target == self._packer.seq_len:
            return
        # finish the pending rows at the OLD shape (no samples are lost,
        # no token silently truncated by the shape change)...
        pending = self._packer.reset()
        self._packer = SequencePacker(self.batch_size, target,
                                      pad_id=self.pad_token_id)
        # ...by re-queuing the displaced documents into the new packer
        for doc in pending:
            batch = self._packer.add(doc)
            if batch is not None:
                self._ready.append(batch)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        self._sync_order_version()
        self._apply_seqlen()
        if self._ready:
            return self._ready.pop(0)
        if not self.pack_sequences:
            return self._collate_fixed()
        while True:
            batch = self._packer.add(next(self.stream))
            if batch is not None:
                return batch

    def _collate_fixed(self) -> Dict[str, np.ndarray]:
        B, S = self.batch_size, self._packer.seq_len
        input_ids = np.full((B, S), self.pad_token_id, dtype=np.int32)
        segment_ids = np.zeros((B, S), dtype=np.int32)
        positions = np.zeros((B, S), dtype=np.int32)
        for r in range(B):
            sample = next(self.stream)
            if isinstance(sample, dict):
                sample = sample["input_ids"]
            tokens = np.asarray(sample, dtype=np.int32).reshape(-1)[:S]
            n = len(tokens)
            input_ids[r, :n] = tokens
            segment_ids[r, :n] = 1
            positions[r, :n] = np.arange(n, dtype=np.int32)
        return {
            "input_ids": input_ids,
            "labels": input_ids.copy(),
            "segment_ids": segment_ids,
            "positions": positions,
        }
