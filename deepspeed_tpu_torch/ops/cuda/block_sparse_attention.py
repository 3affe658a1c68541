"""Block-sparse attention on Hopper, forward and backward (counterpart of
the kernels of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``:
``_fwd_kernel`` :84, ``_dq_kernel`` :129, ``_dkv_kernel`` :168 and the custom
VJP of ``_build_op`` :221).

``block_sparse_fwd`` launches B5 and ``block_sparse_bwd`` B6 (dq) and B7 (dk,
dv) of ``csrc/block_sparse_attention.cu`` for CUDA tensors, or raises; for
CPU tensors they compute ``block_sparse_attention_reference`` and
``block_sparse_attention_backward_reference``, full-matrix f32 versions of
the same functions under the block-expanded layout mask. The kernels read the
layout through compact index tables (``IndexTables``, built once per layout
and device by ``build_index_tables``). At block 128 in bf16 all three are
Hopper kernels (wgmma, TMA, warp specialisation) on the flash kernels'
consumer passes: B5 on the forward's, B6 and B7 on the backward's. They
take the table rows (B5, B6: query blocks) or columns (B7: key blocks) with
the most active blocks first (``row_order``: ``korder``, ``qorder``). The
other blocks keep the ``mma.sync`` kernels and f32 the FMA kernels
(``kernel_variant`` says which runs).
``BlockSparseAttentionFunction`` ties them together; its forward saves q, k,
v, o and lse. Layout is the model's ``[batch, seq, heads, head_dim]``; lse is
``[batch, heads, seq]`` f32.
"""

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from deepspeed_tpu_torch.ops.cuda.build import load_library
from deepspeed_tpu_torch.ops.cuda.common import NEG_INF, check_current_device
from deepspeed_tpu_torch.ops.cuda.flash_attention import _check_launch, bwd_delta

# what the kernels are instantiated for (csrc/block_sparse_attention.cu)
HEAD_DIMS = (64, 128)
BLOCKS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the counts were last set to 0 (CPU calls never
# count): B5 (forward), B6 (dq) and B7 (dk, dv)
launches_sparse_fwd = 0
launches_sparse_dq = 0
launches_sparse_dkv = 0


@dataclasses.dataclass(frozen=True)
class IndexTables:
    """A layout ([1 or H, nq, nk] 0/1) and its kernel tables on one device:
    ``kidx`` [HL, nq, width] int32 holds each q-block row's active key blocks
    in ascending order (-1 past ``kcnt`` [HL, nq]), ``qidx``/``qcnt`` the same
    for each key-block column. Head h reads table h % HL. ``korder``
    [HL * nq] int32 lists the row tables' rows (hl * nq + q-block) longest
    first, the order in which B5 and B6 at block 128 take them; ``qorder``
    [HL * nk] the column tables' columns (hl * nk + k-block) longest first,
    B7's order."""

    layout: np.ndarray
    kidx: torch.Tensor
    kcnt: torch.Tensor
    qidx: torch.Tensor
    qcnt: torch.Tensor
    korder: torch.Tensor
    qorder: torch.Tensor


def active_lists(rows: np.ndarray):
    """``(idx, counts)`` for a boolean ``[heads, n, nk]`` array: each row's
    active columns in ascending order, -1 padded to the widest row (at
    least 1), and their counts."""
    counts = rows.sum(axis=-1).astype(np.int32)
    width = max(int(counts.max()), 1)
    idx = np.full(rows.shape[:2] + (width,), -1, dtype=np.int32)
    for h in range(rows.shape[0]):
        for r in range(rows.shape[1]):
            nz = np.nonzero(rows[h, r])[0]
            idx[h, r, :len(nz)] = nz
    return idx, counts


def row_order(counts):
    """The rows of a [HL, n] table of active counts, flattened to
    hl * n + block, most active first (ties in row order): launched in this
    order, a BigBird global row (or column) starts at once and the band
    rows fill the tail of the grid."""
    flat = np.asarray(counts).reshape(-1)
    return np.argsort(-flat, kind="stable").astype(np.int32)


def build_index_tables(layout, device) -> IndexTables:
    """The tables of ``layout`` on ``device``: one host-to-device copy each,
    made here and never per call."""
    layout = np.asarray(layout)
    if layout.ndim != 3:
        raise ValueError(f"layout must be [heads, nq, nk], got {layout.shape}")
    active = layout != 0
    kidx, kcnt = active_lists(active)
    qidx, qcnt = active_lists(active.transpose(0, 2, 1))

    def put(x):
        return torch.from_numpy(x).to(device)

    return IndexTables(layout, put(kidx), put(kcnt), put(qidx), put(qcnt),
                       put(row_order(kcnt)), put(row_order(qcnt)))


@functools.cache
def _kernels():
    lib = load_library("block_sparse_attention")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # width, HL, block, B, T, H, D, strides, scale, causal, dtype, stream,
    # and the row (or column) order
    tail = [i32] * 7 + [ptr, f32, i32, i32, ptr, ptr]
    fwd, dq, dkv, variant = (lib.ds_block_sparse_fwd, lib.ds_block_sparse_dq,
                             lib.ds_block_sparse_dkv, lib.ds_block_sparse_variant)
    fwd.argtypes = [ptr] * 7 + tail
    dq.argtypes = [ptr] * 9 + tail
    dkv.argtypes = [ptr] * 10 + tail
    variant.argtypes = [i32, i32]
    for fn in (fwd, dq, dkv, variant):
        fn.restype = i32
    return fwd, dq, dkv, variant


_VARIANTS = {0: "fma", 1: "mma.sync", 2: "wgmma"}


def kernel_variant(dtype, block):
    """The design the kernels launch at ``block`` for ``dtype``, as the C
    dispatch decides it: "wgmma" (wgmma + TMA + warp specialisation),
    "mma.sync" or "fma". Builds the library on first use."""
    code = _kernels()[3](block, _DTYPE_CODES[dtype])
    if code not in _VARIANTS:
        raise ValueError(f"no block-sparse kernel for block {block} and {dtype}")
    return _VARIANTS[code]


def _check(q, k, v, layout, block):
    if q.dim() != 4:
        raise ValueError(f"q must be [batch, seq, heads, head_dim], got {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v shapes differ: {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k, v are on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block-sparse attention runs on cuda or cpu, not {q.device}")
    _, t, h, _ = q.shape
    h_layout, nq, nk = layout.shape
    if h_layout not in (1, h):
        raise ValueError(f"layout has {h_layout} head layouts; expected 1 or {h}")
    if nq != nk or t != nq * block:
        raise ValueError(
            f"layout {tuple(layout.shape)} at block {block} covers {nq * block} "
            f"positions, inputs have {t}")


def _check_card(q, block):
    """What the kernels take; any other shape raises (no quiet fallback).
    The grids: (B * H, T / min(block, 64)), and at block 128 in bf16 one
    dimension of B * H * T / 128 blocks."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"the block-sparse kernels take {list(_DTYPE_CODES)}, "
                         f"not {q.dtype} (shape {tuple(q.shape)})")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} of shape {tuple(q.shape)} is not "
                         f"one of {HEAD_DIMS}")
    if block not in BLOCKS:
        raise ValueError(f"block {block} is not one of {BLOCKS}")
    b, t, h, _ = q.shape
    if b * h * (t // min(block, 64)) >= 2 ** 31 or t // min(block, 64) > 65535:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the kernels' grid")


def keep_mask(layout, block, causal, device):
    """[1, 1 or H, T, T] bool: the block-expanded layout, and with ``causal``
    q_pos >= k_pos. Heads that share one layout keep a single copy."""
    layout = np.asarray(layout)
    if layout.shape[0] > 1 and (layout == layout[:1]).all():
        layout = layout[:1]
    keep = torch.from_numpy(layout != 0).to(device)
    keep = keep.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        keep = keep & torch.ones(keep.shape[-2:], dtype=torch.bool,
                                 device=device).tril()
    return keep[None]


def _scores(q, k, layout, block, causal, scale):
    """f32 [B, H, T, T] scaled scores with NEG_INF at masked pairs, the keep
    mask, and the f32 [B, H, T, D] views of q and k."""
    qf, kf = (x.transpose(1, 2).float() for x in (q, k))
    keep = keep_mask(layout, block, causal, q.device)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    return torch.where(keep, s, torch.full_like(s, NEG_INF)), keep, qf, kf


def block_sparse_attention_reference(q, k, v, layout, *, block, causal=False,
                                     scale=None):
    """Plain PyTorch version of B5: the full [T, T] f32 score matrix under
    the block-expanded layout (and causal) mask, masked pairs at exactly 0
    weight. Returns ``(o [B, T, H, D] in q's dtype, lse [B, H, T] f32)``; a
    row with no visible key gets o = 0 and lse = NEG_INF."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s, keep, _, _ = _scores(q, k, layout, block, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(-1)
    seen = l > 0
    l_safe = torch.where(seen, l, torch.ones_like(l))
    o = torch.matmul(p, v.transpose(1, 2).float()) / l_safe[..., None]
    lse = torch.where(seen, m[..., 0] + torch.log(l_safe),
                      torch.full_like(l, NEG_INF))
    return o.transpose(1, 2).to(q.dtype), lse


def block_sparse_attention_backward_reference(q, k, v, o, lse, do, layout, *,
                                              block, causal=False, scale=None):
    """Plain PyTorch version of B6 and B7: P recomputed from the saved lse
    over the full [T, T] matrix with the forward's masks (0 on rows whose lse
    is NEG_INF), then ``delta = rowsum(o * do)``, ``dS = P * (do v^T -
    delta)``, ``dq = scale dS k``, ``dk = scale dS^T q`` and ``dv = P^T do``,
    all in f32. Returns ``(dq, dk, dv)`` ``[B, T, H, D]`` in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s, keep, qf, kf = _scores(q, k, layout, block, causal, scale)
    vf, of, dof = (x.transpose(1, 2).float() for x in (v, o, do))
    keep = keep & (lse > 0.5 * NEG_INF)[..., None]
    p = torch.where(keep, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    delta = (of * dof).sum(-1)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return tuple(x.transpose(1, 2).to(q.dtype) for x in (dq, dk, dv))


def _call(fn, q, k, v, rows, block, causal, scale, *ptrs):
    """One kernel over ``rows`` (kidx, kcnt and korder, or qidx, qcnt and
    qorder); ``ptrs`` are the kernel's own pointer arguments between v and
    the tables."""
    b, t, h, d = q.shape
    idx, cnt, order = rows
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    check_current_device(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), *ptrs,
                  idx.data_ptr(), cnt.data_ptr(), idx.shape[-1], idx.shape[0],
                  block, b, t, h, d, ctypes.cast(strides, ctypes.c_void_p),
                  float(scale), int(bool(causal)), _DTYPE_CODES[q.dtype], stream,
                  order.data_ptr())


def _rows(tables):
    return tables.kidx, tables.kcnt, tables.korder


def _columns(tables):
    return tables.qidx, tables.qcnt, tables.qorder


def _launch_fwd(q, k, v, tables, block, causal, scale):
    """B5: ``(o, lse)``."""
    global launches_sparse_fwd
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    err = _call(_kernels()[0], q, k, v, _rows(tables), block, causal, scale,
                o.data_ptr(), lse.data_ptr())
    if err:
        raise RuntimeError(f"block-sparse forward kernel failed: CUDA error {err}")
    launches_sparse_fwd += 1
    return o, lse


def _launch_dq(q, k, v, lse, delta, do, tables, block, causal, scale):
    """B6 alone, from a precomputed ``delta`` [B, H, T] f32."""
    global launches_sparse_dq
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    err = _call(_kernels()[1], q, k, v, _rows(tables), block, causal, scale,
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr())
    if err:
        raise RuntimeError(f"block-sparse dq kernel failed: CUDA error {err}")
    launches_sparse_dq += 1
    return dq


def _launch_dkv(q, k, v, lse, delta, do, tables, block, causal, scale):
    """B7 alone, from a precomputed ``delta`` [B, H, T] f32."""
    global launches_sparse_dkv
    dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    err = _call(_kernels()[2], q, k, v, _columns(tables), block, causal,
                scale, do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr())
    if err:
        raise RuntimeError(f"block-sparse dkv kernel failed: CUDA error {err}")
    launches_sparse_dkv += 1
    return dk, dv


def _checked_tables(q, tables):
    if tables.kidx.device != q.device:
        raise ValueError(f"index tables are on {tables.kidx.device}, inputs on "
                         f"{q.device}")
    return tables


def block_sparse_fwd(q, k, v, tables: IndexTables, *, block, causal=False,
                     scale=None):
    """Attention over ``[batch, seq, heads, head_dim]`` inputs restricted to
    the active blocks of ``tables.layout``. Returns ``(o, lse)``: o in q's
    dtype, lse ``[batch, heads, seq]`` f32. CUDA tensors run B5; CPU tensors
    run ``block_sparse_attention_reference``."""
    _check(q, k, v, tables.layout, block)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return block_sparse_attention_reference(
            q, k, v, tables.layout, block=block, causal=causal, scale=scale)
    _check_card(q, block)
    _check_launch(q, k, v)
    return _launch_fwd(q, k, v, _checked_tables(q, tables), block, causal, scale)


def block_sparse_bwd(q, k, v, o, lse, do, tables: IndexTables, *, block,
                     causal=False, scale=None):
    """Gradients ``(dq, dk, dv)`` in q's dtype from the forward's inputs, its
    output ``o``, its ``lse`` and the output's gradient ``do``. CUDA tensors
    run the delta prologue (plain PyTorch, f32) then B6 and B7; CPU tensors
    run ``block_sparse_attention_backward_reference``."""
    _check(q, k, v, tables.layout, block)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"o {tuple(o.shape)} and do {tuple(do.shape)} must have q's shape "
            f"{tuple(q.shape)}")
    b, t, h, _ = q.shape
    if tuple(lse.shape) != (b, h, t) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be f32 [batch, heads, seq] = {(b, h, t)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    # autograd hands over do in whatever layout the consumer produced
    do = do.to(q.dtype).contiguous()
    if q.device.type == "cpu":
        return block_sparse_attention_backward_reference(
            q, k, v, o, lse, do, tables.layout, block=block, causal=causal,
            scale=scale)
    _check_card(q, block)
    _check_launch(q, k, v)
    tables = _checked_tables(q, tables)
    delta = bwd_delta(o, do)
    lse = lse.contiguous()
    args = (q, k, v, lse, delta, do, tables, block, causal, scale)
    return (_launch_dq(*args), *_launch_dkv(*args))


class BlockSparseAttentionFunction(torch.autograd.Function):
    """Block-sparse attention with its gradient (``_build_op``'s custom VJP):
    the forward runs B5 and saves q, k, v, o and lse; the backward runs the
    delta prologue, B6 and B7."""

    @staticmethod
    def forward(ctx, q, k, v, tables, block, causal, scale):
        o, lse = block_sparse_fwd(q, k, v, tables, block=block, causal=causal,
                                  scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.block, ctx.causal, ctx.scale = tables, block, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_bwd(q, k, v, o, lse, do, ctx.tables,
                                      block=ctx.block, causal=ctx.causal,
                                      scale=ctx.scale)
        return dq, dk, dv, None, None, None, None
