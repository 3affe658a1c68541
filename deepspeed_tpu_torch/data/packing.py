"""Sequence packing (counterpart of ``deepspeed_tpu/data/packing.py``,
numpy only, kept as its own copy): bin-pack variable-length documents into
fixed [B, S] batches with segment ids and per-segment position resets; the
batches are the JAX package's, array for array.

Packed batch format (all ``int32``, all ``[B, S]``; the engine casts them to
int64 on the way to the card):

* ``input_ids`` — document tokens back to back, ``pad_id`` in the slack;
* ``labels`` — identical to ``input_ids`` (the model's loss shift derives
  next-token targets and zero-weights the positions that would cross a
  segment boundary — ``models/transformer_lm.py`` ``_shifted_targets``);
* ``segment_ids`` — 1-based per-row document index, 0 marks padding;
* ``positions`` — position WITHIN the document (reset to 0 at each
  segment start), the learned position embedding's index.

Exactness: with attention restricted to causal AND same-segment (the
segment variant of the flash kernels, or the einsum path's mask), positions
reset per segment, and loss weights that zero any position whose next
token belongs to another segment, the packed forward computes each
document as if it ran alone, and the weighted-mean cross entropy over a
packed batch is the token-weighted mean of the per-document losses.

The packer is a deterministic greedy first-fit streamer: documents arrive
in stream order, land in the first open row with space, and a document
that fits no row flushes the batch and seeds the next one. Determinism
(no reordering, no lookahead) is what makes mid-epoch resume exact: the
pending rows are part of ``state_dict``, as plain lists of ints.
"""

from typing import Any, Dict, List, Optional

import numpy as np


def _as_tokens(doc) -> np.ndarray:
    """Accept a raw token sequence or a dict sample with ``input_ids``."""
    if isinstance(doc, dict):
        doc = doc["input_ids"]
    arr = np.asarray(doc, dtype=np.int32).reshape(-1)
    if arr.size == 0:
        raise ValueError("cannot pack an empty document")
    return arr


class SequencePacker:
    """Greedy first-fit packing of documents into ``[batch_size, seq_len]``.

    ``add(doc)`` returns a finished batch dict when the incoming document
    forced a flush, else ``None``. ``flush()`` emits the pending partial
    rows (used at explicit boundaries, e.g. a curriculum seq-len change).
    """

    def __init__(self, batch_size: int, seq_len: int, pad_id: int = 0):
        if batch_size < 1 or seq_len < 2:
            raise ValueError(
                f"need batch_size >= 1 and seq_len >= 2, got "
                f"{batch_size}x{seq_len}")
        self.batch_size = batch_size
        self.seq_len = seq_len
        self.pad_id = pad_id
        self._rows: List[List[np.ndarray]] = []

    # -- state -------------------------------------------------------------
    def pending_documents(self) -> List[np.ndarray]:
        """Documents buffered in partial rows, in placement order."""
        return [doc for row in self._rows for doc in row]

    def state_dict(self) -> Dict[str, Any]:
        # plain lists of ints: must survive the checkpoint meta's msgpack
        return {
            "seq_len": self.seq_len,
            "rows": [[doc.tolist() for doc in row] for row in self._rows],
        }

    def load_state_dict(self, state: Dict[str, Any]):
        self.seq_len = int(state.get("seq_len", self.seq_len))
        self._rows = [
            [np.asarray(doc, dtype=np.int32) for doc in row]
            for row in state.get("rows", [])
        ]

    def reset(self) -> List[np.ndarray]:
        """Drop pending rows, returning the displaced documents."""
        pending = self.pending_documents()
        self._rows = []
        return pending

    # -- packing -----------------------------------------------------------
    def _row_used(self, row: List[np.ndarray]) -> int:
        return sum(len(d) for d in row)

    def add(self, doc) -> Optional[Dict[str, np.ndarray]]:
        tokens = _as_tokens(doc)[:self.seq_len]
        for row in self._rows:
            if self._row_used(row) + len(tokens) <= self.seq_len:
                row.append(tokens)
                return None
        if len(self._rows) < self.batch_size:
            self._rows.append([tokens])
            return None
        batch = self._build(self._rows)
        self._rows = [[tokens]]
        return batch

    def flush(self) -> Optional[Dict[str, np.ndarray]]:
        if not self._rows:
            return None
        batch = self._build(self._rows)
        self._rows = []
        return batch

    def _build(self, rows) -> Dict[str, np.ndarray]:
        B, S = self.batch_size, self.seq_len
        input_ids = np.full((B, S), self.pad_id, dtype=np.int32)
        segment_ids = np.zeros((B, S), dtype=np.int32)
        positions = np.zeros((B, S), dtype=np.int32)
        for r, row in enumerate(rows):
            off = 0
            for seg, doc in enumerate(row, start=1):
                n = len(doc)
                input_ids[r, off:off + n] = doc
                segment_ids[r, off:off + n] = seg
                positions[r, off:off + n] = np.arange(n, dtype=np.int32)
                off += n
        return {
            "input_ids": input_ids,
            "labels": input_ids.copy(),
            "segment_ids": segment_ids,
            "positions": positions,
        }


def pack_documents(docs, batch_size: int, seq_len: int,
                   pad_id: int = 0) -> List[Dict[str, np.ndarray]]:
    """One-shot convenience: pack a finite document list into batches
    (including a final partial batch). Same greedy first-fit order as the
    streaming packer."""
    packer = SequencePacker(batch_size, seq_len, pad_id=pad_id)
    out = []
    for doc in docs:
        batch = packer.add(doc)
        if batch is not None:
            out.append(batch)
    tail = packer.flush()
    if tail is not None:
        out.append(tail)
    return out
