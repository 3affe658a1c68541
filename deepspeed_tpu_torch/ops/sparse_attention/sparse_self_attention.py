"""Block-sparse attention and its module (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``).

Three implementations of attention over ``[batch, seq, heads, head_dim]``
restricted to the active blocks of a ``[heads or 1, nq, nk]`` 0/1 layout,
as in the JAX package:

* ``block_sparse_attention``: the streaming kernels (B5 forward, B6 and B7
  backward, ``ops/cuda/block_sparse_attention.py``), differentiable. The
  kernels' index tables are built once per (layout, heads, block, device)
  and kept in a bounded cache; a CUDA graph captured over the call holds
  the tables it uses, so an eviction cannot free what a replay reads.
* ``gathered_blocksparse_attention``: static K/V block gathers followed by
  batched matrix products (the JAX package's default, which XLA compiles to
  einsums; plain PyTorch here), with wide "global" rows split off and
  computed densely, and element masks folded in.
* ``dense_blocksparse_attention``: masked full attention.

The last two keep their index and mask constants on the device, one copy
per content, so that a captured step copies nothing from the host.

``SparseSelfAttention`` routes between them exactly as the JAX module does.
"""

import collections
import hashlib
import math
import warnings

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
    BlockSparseAttentionFunction, keep_mask, active_lists, build_index_tables)
from deepspeed_tpu_torch.ops.cuda.common import NEG_INF
from deepspeed_tpu_torch.runtime import compiled_step

# index tables per (layout, heads, block, device), least recently used first
_OP_CACHE = collections.OrderedDict()
_OP_CACHE_MAX = 64
# the gather and dense paths' constants on the device, by content
_CONST_CACHE = collections.OrderedDict()
_CONST_CACHE_MAX = 256


def _cached_constant(key, make):
    """``make()`` (a device tensor) kept under ``key``: made once, least
    recently used first out, and held by a CUDA graph captured over the
    call, so that a captured step copies nothing from the host. It is made
    outside inference mode, so that a constant first made while serving
    can index a training step's tensors (autograd saves the indices)."""
    t = _CONST_CACHE.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CONST_CACHE[key] = make()
        while len(_CONST_CACHE) > _CONST_CACHE_MAX:
            _CONST_CACHE.popitem(last=False)
    else:
        _CONST_CACHE.move_to_end(key)
    compiled_step.hold(t)
    return t


def _digest(x: np.ndarray) -> bytes:
    return hashlib.blake2b(np.ascontiguousarray(x).tobytes(),
                           digest_size=16).digest()


def _device_constant(x, device):
    """The numpy array ``x`` on ``device`` (one copy per content)."""
    x = np.asarray(x)
    return _cached_constant(
        ("array", _digest(x), x.shape, x.dtype.str, str(torch.device(device))),
        lambda: torch.from_numpy(np.ascontiguousarray(x)).to(device))


def _build_index_tables(layout: np.ndarray, num_heads: int, block: int, device):
    """The kernels' tables for ``layout`` on ``device``, from the bounded
    cache or built (one host-to-device copy per table) and cached."""
    h_layout = layout.shape[0]
    if h_layout not in (1, num_heads):
        raise ValueError(
            f"layout has {h_layout} head layouts; expected 1 or {num_heads}")
    key = (layout.tobytes(), layout.shape, str(layout.dtype), num_heads,
           int(block), str(torch.device(device)))
    tables = _OP_CACHE.get(key)
    if tables is None:
        tables = build_index_tables(layout, device)
        _OP_CACHE[key] = tables
        while len(_OP_CACHE) > _OP_CACHE_MAX:
            _OP_CACHE.popitem(last=False)
    else:
        _OP_CACHE.move_to_end(key)
    return tables


def block_sparse_attention(q, k, v, layout, *, block: int,
                           causal: bool = False, scale: float = None):
    """Attention over ``[batch, seq, heads, head_dim]`` restricted to the
    active blocks of ``layout`` ([heads or 1, nq, nk] 0/1 array), through
    the block-sparse kernels (their plain versions for CPU tensors)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    layout = np.asarray(layout)
    t = q.shape[1]
    if t != layout.shape[1] * block:
        raise ValueError(
            f"layout covers {layout.shape[1] * block} positions, "
            f"inputs have {t}")
    tables = _build_index_tables(layout, q.shape[2], block, q.device)
    compiled_step.hold(tables)
    return BlockSparseAttentionFunction.apply(q, k, v, tables, int(block),
                                              bool(causal), float(scale))


def _partition_rows(counts: np.ndarray, nk: int):
    """Split query-block rows into a LIGHT set (narrow, gather path) and a
    HEAVY set (wide, dense path) minimizing total key-block work.

    Sparsity layouts are bimodal: banded rows touch a handful of blocks
    while "global" rows touch every block, and a single gather table padded
    to the max row width would degenerate to dense-everything. So pick the
    width cutoff that minimizes ``W_light * n_light + nk * n_heavy``.
    ``counts`` is the per-row active-block count, max-reduced over head
    layouts. Returns (light_rows, heavy_rows) as sorted index arrays.
    """
    nq = counts.shape[0]
    order = np.argsort(counts)           # ascending width
    sorted_counts = counts[order]
    best_cost, best_split = None, nq     # split = first heavy position
    for split in range(nq + 1):
        w_light = int(sorted_counts[split - 1]) if split else 0
        cost = w_light * split + (nq - split) * nk
        if best_cost is None or cost < best_cost:
            best_cost, best_split = cost, split
    light = np.sort(order[:best_split])
    heavy = np.sort(order[best_split:])
    return light, heavy


def _compact_index_tables(layout: np.ndarray, rows: np.ndarray):
    """Active key-block lists for the given rows, at their true max width
    (the gather path's cost is linear in this width). ``layout`` is
    [hL, nq, nk]; returns ``idx [hL, len(rows), W]`` int32, -1 padded."""
    return active_lists(layout[:, rows] != 0)[0]


def gathered_blocksparse_attention(q, k, v, layout, *, block: int,
                                   causal: bool = False, scale: float = None,
                                   key_padding_mask=None, attn_mask=None,
                                   key_padding_mask_mode: str = "add",
                                   attn_mask_mode: str = "mul"):
    """Block-sparse attention by gathering each query row's active K/V
    blocks with static indices, then batched products over the gathered
    width; wide "global" rows are split off and computed densely. Scores are
    f32 (the operands upcast, as JAX's ``preferred_element_type=f32``);
    probabilities are cast to q's dtype before the product with V. Autograd
    differentiates through it, and element masks fold in by gathering mask
    blocks with the same indices."""
    b, t, heads, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    layout = np.asarray(layout)
    h_layout, nq, nk = layout.shape
    if h_layout not in (1, heads):
        raise ValueError(
            f"layout has {h_layout} head layouts; expected 1 or {heads}")
    if t != nq * block:
        raise ValueError(
            f"layout covers {nq * block} positions, inputs have {t}")
    if h_layout > 1 and (layout == layout[:1]).all():
        # heads that share one layout share its tables and masks
        layout, h_layout = layout[:1], 1
    # the layout's identity for its derived constants: hashing the layout,
    # not the (up to [heads, nq, block, W, block]) masks made from it
    lay_key = ("gather", _digest(layout), layout.shape, int(block),
               bool(causal), str(q.device))

    counts = layout.sum(axis=-1).max(axis=0)          # [nq], max over heads
    light_rows, heavy_rows = _partition_rows(counts, nk)

    dtype, dev = q.dtype, q.device
    neg = NEG_INF

    def blocks(x):                                    # [B, H, n, block, D]
        return x.reshape(b, nq, block, heads, d).permute(0, 3, 1, 2, 4)

    qb, kb, vb = blocks(q), blocks(k), blocks(v)
    kpb = None
    if key_padding_mask is not None:
        kpb = torch.as_tensor(key_padding_mask, device=dev).reshape(b, nq, block)
    amp = None
    if attn_mask is not None:
        amp = torch.as_tensor(attn_mask, device=dev).reshape(nq, block, nq, block)

    def softmax_rows(s, row_shape):
        """Masked softmax over the flattened key axes, NaN-safe for rows
        whose every key is masked (possible under padding masks)."""
        sf = s.reshape(row_shape)
        m = sf.amax(-1, keepdim=True)
        e = torch.exp(sf - m.clamp_min(neg / 2).detach())
        denom = e.sum(-1, keepdim=True).clamp_min(1e-30)
        return (e / denom).to(dtype).reshape(s.shape)

    def apply_kpm(s, kp):                             # kp: [B, ..., block]
        if key_padding_mask_mode == "mul":
            return torch.where(kp > 0, s, neg)
        return s + kp.float()

    def apply_am(s, am_part):
        if attn_mask_mode == "mul":
            return torch.where(am_part > 0, s, neg)
        return s + am_part.float()

    def put(x):
        return _device_constant(x, dev)

    out_parts, out_rows = [], []

    if len(light_rows):
        idx = _compact_index_tables(layout, light_rows)  # [hL, nL, W] static
        w = idx.shape[-1]
        nl = len(light_rows)
        gidx = put(np.maximum(idx, 0).astype(np.int64))
        ql = qb[:, :, put(light_rows)]                # [B, H, nL, block, D]
        if h_layout == 1:
            kg = kb[:, :, gidx[0]]                    # [B, H, nL, W, block, D]
            vg = vb[:, :, gidx[0]]
        else:
            heads_ix = put(np.arange(heads))[:, None, None]
            kg = kb[:, heads_ix, gidx]
            vg = vb[:, heads_ix, gidx]
        s = torch.einsum("bhqid,bhqwjd->bhqiwj", ql.float(), kg.float()) * scale
        valid = put(idx >= 0)                         # [hL, nL, W] static
        s = torch.where(valid[None, :, :, None, :, None], s, neg)
        if causal:
            def light_causal():
                q_pos = (light_rows[:, None] * block
                         + np.arange(block)[None, :])     # [nL, block]
                k_pos = idx[..., None] * block + np.arange(block)
                cm = (k_pos[:, :, None, :, :]
                      <= q_pos[None, :, :, None, None])   # [hL,nL,block,W,block]
                return torch.from_numpy(cm).to(dev)

            cm = _cached_constant(lay_key + ("light_causal",), light_causal)
            s = torch.where(cm[None], s, neg)
        if amp is not None:
            flat = amp.permute(0, 2, 1, 3).reshape(nq * nq, block, block)
            pair = light_rows[None, :, None] * nq + np.maximum(idx, 0)
            am_g = flat[put(pair.astype(np.int64))]   # [hL,nL,W,block,block]
            s = apply_am(s, am_g.permute(0, 1, 3, 2, 4)[None])
        if kpb is not None:
            kp_g = kpb[:, gidx]                       # [B, hL, nL, W, block]
            s = apply_kpm(s, kp_g[:, :, :, None])
        p = softmax_rows(s, (b, heads, nl, block, w * block))
        o = torch.einsum("bhqiwj,bhqwjd->bhqid", p, vg)
        out_parts.append(o)
        out_rows.append(light_rows)

    if len(heavy_rows):
        nh = len(heavy_rows)
        qh = qb[:, :, put(heavy_rows)]                # [B, H, nH, block, D]
        s = torch.einsum("bhrid,bhnjd->bhrinj", qh.float(), kb.float()) * scale
        row_mask = put(layout[:, heavy_rows] != 0)    # [hL, nH, nk] static
        s = torch.where(row_mask[None, :, :, None, :, None], s, neg)
        if causal:
            def heavy_causal():
                q_pos = (heavy_rows[:, None] * block
                         + np.arange(block)[None, :])     # [nH, block]
                k_pos = (np.arange(nk)[:, None] * block
                         + np.arange(block)[None, :])     # [nk, block]
                cm = (k_pos[None, None, :, :]
                      <= q_pos[:, :, None, None])         # [nH, block, nk, block]
                return torch.from_numpy(cm).to(dev)

            cm = _cached_constant(lay_key + ("heavy_causal",), heavy_causal)
            s = torch.where(cm[None, None], s, neg)
        if amp is not None:
            am_h = amp[put(heavy_rows)]               # [nH, block, nq, block]
            s = apply_am(s, am_h[None, None])
        if kpb is not None:
            s = apply_kpm(s, kpb[:, None, None, None])
        p = softmax_rows(s, (b, heads, nh, block, nk * block))
        o = torch.einsum("bhrinj,bhnjd->bhrid", p, vb)
        out_parts.append(o)
        out_rows.append(heavy_rows)

    o = out_parts[0] if len(out_parts) == 1 else torch.cat(out_parts, dim=2)
    order = np.concatenate(out_rows)
    if not np.array_equal(order, np.arange(nq)):
        o = o[:, :, put(np.argsort(order))]
    return o.permute(0, 2, 3, 1, 4).reshape(b, t, heads, d).to(dtype)


def dense_blocksparse_attention(q, k, v, layout, *, block: int,
                                causal: bool = False, scale: float = None,
                                key_padding_mask=None, attn_mask=None,
                                key_padding_mask_mode: str = "add",
                                attn_mask_mode: str = "mul"):
    """Masked full attention: the block layout expanded to an element mask,
    f32 scores and softmax. For testing and for the mask-bearing inputs the
    streaming kernels do not take."""
    b, t, heads, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    neg = NEG_INF
    layout = np.asarray(layout)
    keep = _cached_constant(
        ("keep", _digest(layout), layout.shape, int(block), bool(causal),
         str(q.device)), lambda: keep_mask(layout, block, causal, q.device))
    s = torch.where(keep, s, neg)
    if attn_mask is not None:
        am = torch.as_tensor(attn_mask, device=q.device)
        if attn_mask_mode == "mul":
            s = torch.where(am[None, None] > 0, s, neg)
        else:
            s = s + am[None, None]
    if key_padding_mask is not None:
        kpm = torch.as_tensor(key_padding_mask, device=q.device)  # [b, t]
        if key_padding_mask_mode == "mul":
            s = torch.where(kpm[:, None, None, :] > 0, s, neg)
        else:
            s = s + kpm[:, None, None, :]
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


class SparseSelfAttention:
    """Module-level API of the JAX package's ``SparseSelfAttention``:
    scaled dot-product attention under the config's block-sparsity layout.

    ``impl`` (default: the config's ``kernel_impl``, else "gather") picks
    the implementation: "gather", "pallas" (the block-sparse kernels; the
    name is the JAX config's) or "dense". "pallas" with an element mask
    warns and takes the dense path, as in the JAX module."""

    def __init__(self, sparsity_config, key_padding_mask_mode: str = "add",
                 attn_mask_mode: str = "mul", max_seq_length: int = 2048,
                 impl: str = None, heads=None):
        self.sparsity_config = sparsity_config
        # (first head, count): a tensor-parallel rank's heads, whose
        # layouts are the rows of the whole layout it keeps
        self.heads = heads
        if key_padding_mask_mode not in ("add", "mul"):
            raise ValueError("key_padding_mask_mode must be 'add' or 'mul'")
        if attn_mask_mode not in ("add", "mul"):
            raise ValueError("attn_mask_mode must be 'add' or 'mul'")
        self.key_padding_mask_mode = key_padding_mask_mode
        self.attn_mask_mode = attn_mask_mode
        self.max_seq_length = max_seq_length
        if impl is None:
            impl = getattr(sparsity_config, "kernel_impl", None) or "gather"
        if impl not in ("gather", "pallas", "dense"):
            raise ValueError("impl must be 'gather', 'pallas' or 'dense'")
        self.impl = impl
        self._layouts = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len > self.max_seq_length:
            raise ValueError(
                f"seq_len {seq_len} exceeds max_seq_length "
                f"{self.max_seq_length}")
        if seq_len not in self._layouts:
            layout = self.sparsity_config.make_layout(seq_len)
            if self.heads is not None:
                start, n = self.heads
                layout = np.ascontiguousarray(layout[start:start + n])
            self._layouts[seq_len] = layout
        return self._layouts[seq_len]

    def __call__(self, query, key, value, key_padding_mask=None,
                 attn_mask=None, causal=None):
        layout = self.get_layout(query.shape[1])
        if causal is None:
            causal = getattr(self.sparsity_config, "attention",
                             "bidirectional") == "unidirectional"
        block = self.sparsity_config.block
        if self.impl == "gather":
            return gathered_blocksparse_attention(
                query, key, value, layout, block=block, causal=causal,
                key_padding_mask=key_padding_mask, attn_mask=attn_mask,
                key_padding_mask_mode=self.key_padding_mask_mode,
                attn_mask_mode=self.attn_mask_mode)
        if self.impl == "pallas":
            if key_padding_mask is None and attn_mask is None:
                return block_sparse_attention(query, key, value, layout,
                                              block=block, causal=causal)
            # the streaming kernels take no element-level masks; an explicit
            # kernel selection degrading to the quadratic masked-dense path
            # must not happen silently (O(T^2) scores at long seq)
            warnings.warn(
                "sparse_attention kernel='pallas' with an element mask "
                "falls back to masked DENSE attention (full [T, T] "
                "scores); use the default 'gather' impl for masked "
                "inputs", stacklevel=2)
        return dense_blocksparse_attention(
            query, key, value, layout, block=block,
            causal=causal, key_padding_mask=key_padding_mask,
            attn_mask=attn_mask,
            key_padding_mask_mode=self.key_padding_mask_mode,
            attn_mask_mode=self.attn_mask_mode)
