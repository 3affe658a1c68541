"""Shared-prefix KV cache for the continuous-batching scheduler
(counterpart of ``deepspeed_tpu/serving/prefix_cache.py``, the whole
module).

Traffic is prefix-skewed: many requests share a system prompt, and
prefilling it again for every admission costs time to first token. This
module keeps the KV caches of popular padded prompt prefixes, so that the
scheduler's admission prefill resumes mid-prompt instead of starting cold.

* **Keys are padded column prefixes** (pads encoded as -1): positions
  advance for pad columns too and rotary phases are baked into cached keys,
  so a prefix prefilled at pad offset 2 is not the same cache as the same
  tokens at offset 5. Two prompts share an entry iff they agree on the
  leading padded columns: the tokens and ``(-len) % prompt_bucket``.
* **Entries hold one-row caches** (``KVCache.clone`` of the engine's
  batch-1 cache at the cut): the scheduler copies an entry into that cache
  on a hit and continues the prefill there, so an entry is never written.
* **Promotion is by popularity**: every admission counts each aligned
  candidate prefix of its padded prompt; the longest candidate reaching
  ``promote_after`` is copied out during that admission's prefill.

Eviction is LRU over a byte budget: explicit bytes win, else a share of
the card's memory (``torch.cuda.get_device_properties``), else a small
fallback on the CPU. An entry being copied into a lane holds a reference
and is never evicted. Single-threaded, like the scheduler it serves. Each
hit, miss and eviction is counted (``stats``) and published on the
telemetry bus (``serve.prefix_hit``/``_miss``/``_evict``, JAX's payload
keys). Over a tensor- or expert-parallel engine each rank keeps its own
cache of its KV heads under the same keys: rank 0 looks up and promotes,
and the others ``follow`` its decisions (``inference/scheduler.py``).
"""

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from deepspeed_tpu_torch.telemetry.bus import (KIND_SERVE_PREFIX_EVICT,
                                               KIND_SERVE_PREFIX_HIT,
                                               KIND_SERVE_PREFIX_MISS,
                                               publish)

Key = Tuple[int, ...]


@dataclass
class PrefixCacheConfig:
    """Knobs for detection and retention.

    ``align`` sets the candidate prefix boundaries (every multiple of it is
    a possible cut). Any value is exact (continuation spans never cross a
    ring block wherever the cut is), so this is a granularity and memory
    knob; the natural choice is the ring's layout block, or the prompt
    bucket for a dense model.
    """
    align: int = 64
    promote_after: int = 2          # admissions sharing a prefix before
                                    # its KV is kept
    min_prefix_tokens: int = 1      # real (non-pad) tokens a candidate
                                    # must contain
    budget_bytes: Optional[int] = None   # an explicit cap wins over frac
    budget_frac_hbm: float = 0.05        # share of the card's memory
    fallback_budget_bytes: int = 256 << 20  # no card (the CPU)
    counter_capacity: int = 4096    # popularity counters kept (LRU)

    def __post_init__(self):
        if self.align < 1:
            raise ValueError(f"align must be >= 1, got {self.align}")
        if self.promote_after < 1:
            raise ValueError(
                f"promote_after must be >= 1, got {self.promote_after}")


class _Entry:
    __slots__ = ("key", "length", "cache", "nbytes", "refs")

    def __init__(self, key: Key, cache, nbytes: int):
        self.key = key
        self.length = len(key)
        self.cache = cache
        self.nbytes = int(nbytes)
        self.refs = 0


def _tree_nbytes(tree) -> int:
    """The bytes of a cache entry: a ``KVCache`` (its buffers), a tensor,
    an array or a dict or list of them."""
    if hasattr(tree, "nbytes") and callable(tree.nbytes):
        return int(tree.nbytes())
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_nbytes(v) for v in tree)
    if hasattr(tree, "element_size"):
        return int(tree.numel() * tree.element_size())
    return int(getattr(tree, "nbytes", 0))


class PrefixCache:
    """Reference-counted LRU cache of prefilled prompt-prefix caches."""

    def __init__(self, config: Optional[PrefixCacheConfig] = None,
                 device=None):
        self.config = config or PrefixCacheConfig()
        self.budget_bytes = self._resolve_budget(device)
        self._entries: "OrderedDict[Key, _Entry]" = OrderedDict()
        self._counts: "OrderedDict[Key, int]" = OrderedDict()
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.insert_skips = 0
        # False on the ranks that follow rank 0 of a serving group: their
        # copy of the cache publishes nothing
        self.events = True

    def _resolve_budget(self, device) -> int:
        """``budget_bytes``, else ``budget_frac_hbm`` of the card's memory
        (``device``, default the current card when torch sees one), else
        the fallback."""
        cfg = self.config
        if cfg.budget_bytes is not None:
            return int(cfg.budget_bytes)
        import torch

        if device is None and torch.cuda.is_available():
            device = "cuda"
        if device is None or torch.device(device).type != "cuda":
            return int(cfg.fallback_budget_bytes)
        total = torch.cuda.get_device_properties(
            torch.device(device)).total_memory
        return int(total * cfg.budget_frac_hbm)

    # -- candidate geometry -------------------------------------------
    def _pad_offset(self, cols: Key) -> int:
        o = 0
        for c in cols:
            if c >= 0:
                break
            o += 1
        return o

    def _candidate_lengths(self, cols: Key, limit: int):
        """Aligned cut lengths (ascending) eligible as keys: every multiple
        of ``align`` up to ``limit`` that holds at least
        ``min_prefix_tokens`` real tokens."""
        cfg = self.config
        off = self._pad_offset(cols)
        lo = off + cfg.min_prefix_tokens
        a = cfg.align
        first = ((max(lo, a) + a - 1) // a) * a
        return list(range(first, limit + 1, a))

    # -- the scheduler's protocol ---------------------------------------
    def lookup(self, cols: Key, limit: int,
               request_id=None) -> Optional[_Entry]:
        """The longest cached prefix of ``cols[:limit]``, or None. A
        returned entry is pinned (refs + 1): ``release()`` it once it has
        been copied out."""
        for length in reversed(self._candidate_lengths(cols, limit)):
            entry = self._entries.get(cols[:length])
            if entry is not None:
                entry.refs += 1
                self._entries.move_to_end(entry.key)
                self.hits += 1
                publish(KIND_SERVE_PREFIX_HIT, request_id=request_id,
                        prefix_len=entry.length, nbytes=entry.nbytes)
                return entry
        self.misses += 1
        publish(KIND_SERVE_PREFIX_MISS, request_id=request_id,
                prompt_cols=len(cols))
        return None

    def follow(self, key: Key) -> _Entry:
        """The entry rank 0's ``lookup`` found, on a rank that follows it
        (a tp or ep group's other ranks hold the same keys, each with its
        own KV heads): pinned and made most recent as ``lookup`` does."""
        entry = self._entries[key]
        entry.refs += 1
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def release(self, entry: _Entry) -> None:
        entry.refs = max(0, entry.refs - 1)

    def promotion_target(self, cols: Key, limit: int,
                         have: int = 0) -> Optional[int]:
        """Count this prompt for each of its candidate prefixes; return the
        longest length past ``have`` whose count reached ``promote_after``
        and which is not cached yet (the caller copies its cache out
        there), or None."""
        cfg = self.config
        best = None
        for length in self._candidate_lengths(cols, limit):
            key = cols[:length]
            n = self._counts.pop(key, 0) + 1
            self._counts[key] = n  # pop + set keeps the LRU order fresh
            if (n >= cfg.promote_after and length > have
                    and key not in self._entries):
                best = length
        while len(self._counts) > cfg.counter_capacity:
            self._counts.popitem(last=False)
        return best

    def insert(self, key: Key, cache, request_id=None) -> bool:
        """Adopt a prefilled cache for ``key``, evicting the least recently
        used unpinned entries to fit the budget. False (the cache dropped)
        when it cannot fit: every survivor is pinned, or it alone exceeds
        the budget."""
        if key in self._entries:
            self.insert_skips += 1
            return False
        nbytes = _tree_nbytes(cache)
        if not self._make_room(nbytes):
            self.insert_skips += 1
            return False
        self._entries[key] = _Entry(key, cache, nbytes)
        self.bytes_used += nbytes
        self.insertions += 1
        return True

    def _make_room(self, need: int) -> bool:
        if need > self.budget_bytes:
            return False
        while self.bytes_used + need > self.budget_bytes:
            victim = next((e for e in self._entries.values()
                           if e.refs == 0), None)
            if victim is None:
                return False  # everything left is being copied out
            del self._entries[victim.key]
            self.bytes_used -= victim.nbytes
            self.evictions += 1
            if self.events:
                publish(KIND_SERVE_PREFIX_EVICT, prefix_len=victim.length,
                        nbytes=victim.nbytes, bytes_used=self.bytes_used)
        return True

    # -- introspection ------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "bytes_used": self.bytes_used,
            "budget_bytes": self.budget_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
            "insertions": self.insertions,
            "insert_skips": self.insert_skips,
            "evictions": self.evictions,
        }

    def __len__(self) -> int:
        return len(self._entries)
