"""Sparsity-pattern configs producing block-level attention layouts (a copy
of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``).

The same six families with the same constructors and the same numpy draws
(``np.random.RandomState(seed)``), so every layout is bit-identical to the JAX
package's: Dense, Fixed, Variable, BigBird, BSLongformer, LocalSlidingWindow.
A layout is a host-side ``np.ndarray`` of shape ``[num_heads, num_blocks,
num_blocks]`` with 1 marking an active [block, block] tile; the port turns
it into the block-sparse kernels' index tables once per layout and device.
"""

from typing import List, Optional

import numpy as np


class SparsityConfig:
    """Abstract base holding properties shared by all patterns
    (reference sparsity_config.py:9)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(
                f"Sequence length {seq_len} must be divisible by block size "
                f"{self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_heads, num_blocks, num_blocks),
                        dtype=np.int64)

    def check_and_propagate_first_head_layout(
            self, layout: np.ndarray) -> np.ndarray:
        """When all heads share one layout, broadcast head 0 to the rest
        (reference sparsity_config.py:59)."""
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _apply_direction(self, layout: np.ndarray,
                         attention: str) -> np.ndarray:
        """Unidirectional patterns never attend above the block diagonal."""
        if attention == "unidirectional":
            num_blocks = layout.shape[1]
            tril = np.tril(np.ones((num_blocks, num_blocks), dtype=np.int64))
            layout &= tril[None]
        return layout


class DenseSparsityConfig(SparsityConfig):
    """All blocks active; kept for comparison (reference :63)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local windows + fixed global representative blocks
    (reference :94, the pattern of the Sparse Transformer paper)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_local_blocks: int = 4, num_global_blocks: int = 1,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 num_different_global_patterns: int = 1):
        super().__init__(num_heads, block, different_layout_per_head)
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "attention must be uni- or bidirectional")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError(
                "horizontal global attention requires bidirectional attention")
        max_patterns = num_local_blocks // num_global_blocks
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError(
                "multiple global patterns require different_layout_per_head")
        if num_different_global_patterns > max_patterns:
            raise ValueError(
                f"num_different_global_patterns "
                f"{num_different_global_patterns} exceeds "
                f"num_local_blocks/num_global_blocks = {max_patterns}")
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.num_different_global_patterns = num_different_global_patterns

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        for h in range(self.num_layout_heads):
            # local windows: dense [window, window] squares on the diagonal
            for start in range(0, num_blocks, self.num_local_blocks):
                end = min(start + self.num_local_blocks, num_blocks)
                layout[h, start:end, start:end] = 1
            # global blocks: the h-th pattern picks a different representative
            # slot inside each local window, counted from the window's end
            offset = (1 + h % self.num_different_global_patterns) \
                * self.num_global_blocks
            for start in range(0, num_blocks, self.num_local_blocks):
                win_end = min(start + self.num_local_blocks, num_blocks)
                g = min(win_end - offset, num_blocks - self.num_global_blocks)
                g = max(g, start)
                g_end = min(g + self.num_global_blocks, num_blocks)
                # all later rows attend to this window's representative
                layout[h, g_end:, g:g_end] = 1
                if self.horizontal_global_attention:
                    layout[h, g:g_end, :] = 1
            layout[h] = self._apply_direction(layout[h:h + 1],
                                              self.attention)[0]
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """User-shaped pattern: random blocks + variable-size local windows +
    explicit global block indices (reference :243)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 0,
                 local_window_blocks: Optional[List[int]] = None,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional",
                 horizontal_global_attention: bool = False,
                 seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        local_window_blocks = local_window_blocks or [4]
        global_block_indices = (
            [0] if global_block_indices is None else global_block_indices)
        if global_block_end_indices is not None:
            if len(global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must "
                    "have the same length")
            for s, e in zip(global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "attention must be uni- or bidirectional")
        if horizontal_global_attention and attention != "bidirectional":
            raise ValueError(
                "horizontal global attention requires bidirectional attention")
        # random blocks differ per head only if layouts differ per head;
        # a single shared layout still gets one random set
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks
        self.global_block_indices = global_block_indices
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        rng = np.random.RandomState(self.seed)
        for h in range(self.num_layout_heads):
            # variable local windows: sizes from the list, last size repeats
            start = 0
            i = 0
            while start < num_blocks:
                size = self.local_window_blocks[
                    min(i, len(self.local_window_blocks) - 1)]
                end = min(start + size, num_blocks)
                layout[h, start:end, start:end] = 1
                start = end
                i += 1
            # global blocks: rows and columns of the given indices/ranges
            if self.global_block_end_indices is None:
                spans = [(g, g + 1) for g in self.global_block_indices]
            else:
                spans = list(zip(self.global_block_indices,
                                 self.global_block_end_indices))
            for s, e in spans:
                s, e = min(s, num_blocks), min(e, num_blocks)
                layout[h, :, s:e] = 1
                if self.horizontal_global_attention:
                    layout[h, s:e, :] = 1
            # random blocks per row; unidirectional draws from the past so
            # the tril in _apply_direction doesn't discard the picks
            for row in range(num_blocks):
                pool = row + 1 if self.attention == "unidirectional" \
                    else num_blocks
                cols = rng.choice(pool,
                                  size=min(self.num_random_blocks, pool),
                                  replace=False)
                layout[h, row, cols] = 1
            layout[h] = self._apply_direction(layout[h:h + 1],
                                              self.attention)[0]
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """BigBird: random + sliding window + leading global blocks
    (reference :426)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_random_blocks: int = 1,
                 num_sliding_window_blocks: int = 3,
                 num_global_blocks: int = 1,
                 attention: str = "bidirectional", seed: int = 0):
        super().__init__(num_heads, block, different_layout_per_head)
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "attention must be uni- or bidirectional")
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(
                f"num_sliding_window_blocks {self.num_sliding_window_blocks} "
                f"exceeds total blocks {num_blocks}")
        rng = np.random.RandomState(self.seed)
        w = self.num_sliding_window_blocks // 2
        g = min(self.num_global_blocks, num_blocks)
        for h in range(self.num_layout_heads):
            for row in range(num_blocks):
                lo, hi = max(0, row - w), min(row + w + 1, num_blocks)
                layout[h, row, lo:hi] = 1
                # random long-range links; unidirectional draws from the past
                pool = row + 1 if self.attention == "unidirectional" \
                    else num_blocks
                pool = max(pool, 1)
                cols = rng.choice(pool,
                                  size=min(self.num_random_blocks, pool),
                                  replace=False)
                layout[h, row, cols] = 1
            layout[h, :, :g] = 1  # everyone attends to leading globals
            layout[h, :g, :] = 1  # leading globals attend to everyone
            layout[h] = self._apply_direction(layout[h:h + 1],
                                              self.attention)[0]
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Block-sparse Longformer: sliding window + chosen global blocks
    (reference :567)."""

    def __init__(self, num_heads: int, block: int = 16,
                 different_layout_per_head: bool = False,
                 num_sliding_window_blocks: int = 3,
                 global_block_indices: Optional[List[int]] = None,
                 global_block_end_indices: Optional[List[int]] = None,
                 attention: str = "bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        global_block_indices = (
            [0] if global_block_indices is None else global_block_indices)
        if global_block_end_indices is not None:
            if len(global_block_indices) != len(global_block_end_indices):
                raise ValueError(
                    "global_block_indices and global_block_end_indices must "
                    "have the same length")
            for s, e in zip(global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError(
                        f"global block start {s} must be < end {e}")
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices
        self.global_block_end_indices = global_block_end_indices
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            for row in range(num_blocks):
                lo, hi = max(0, row - w), min(row + w + 1, num_blocks)
                layout[h, row, lo:hi] = 1
            if self.global_block_end_indices is None:
                spans = [(g, g + 1) for g in self.global_block_indices]
            else:
                spans = list(zip(self.global_block_indices,
                                 self.global_block_end_indices))
            for s, e in spans:
                s, e = min(s, num_blocks), min(e, num_blocks)
                layout[h, :, s:e] = 1
                layout[h, s:e, :] = 1
            layout[h] = self._apply_direction(layout[h:h + 1],
                                              self.attention)[0]
        return self.check_and_propagate_first_head_layout(layout)


class LocalSlidingWindowSparsityConfig(SparsityConfig):
    """Pure sliding-window pattern (reference :690)."""

    def __init__(self, num_heads: int, block: int = 16,
                 num_sliding_window_blocks: int = 3,
                 attention: str = "unidirectional"):
        super().__init__(num_heads, block)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.attention = attention

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(
                f"num_sliding_window_blocks {self.num_sliding_window_blocks} "
                f"exceeds total blocks {num_blocks}")
        w = self.num_sliding_window_blocks // 2
        for row in range(num_blocks):
            lo = max(0, row - w)
            hi = min(row + w + 1, num_blocks) \
                if self.attention == "bidirectional" else row + 1
            layout[0, row, lo:hi] = 1
        return self.check_and_propagate_first_head_layout(layout)
