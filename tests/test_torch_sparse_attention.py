"""The port's block-sparse attention against the JAX package's.

The same numpy inputs (B=2, T=64, H=2, D=16, block 16, as in
``tests/unit/test_sparse_attention.py``) go through both. On CPU tensors the
port's kernel wrappers run their plain versions; the JAX side runs the
Pallas kernels in interpret mode, as its own tests do. Layouts must be
bit-identical; outputs agree within 2e-4 and gradients within 2e-3, the
tolerances of the JAX package's kernel-against-dense tests. The same
tolerances hold at the geometry of the card's wgmma forward (block 128, D
64, T 1024, H 2: BigBird with one global, three window and one random
block, shared and per-head, both directions), where lse (f32 on both sides)
is held to 2e-4 too.

B5 at block 128 takes the query blocks in the tables' row order, most
active first; the order is checked over every layout family and
BERT-Large's BigBird layout.
"""

import functools
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental import pallas as pl

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops.pallas.common import LSE_LANES
from deepspeed_tpu.ops.sparse_attention import sparse_attention_utils as jutils
from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as jss
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.cuda.common import NEG_INF
from deepspeed_tpu_torch.ops.sparse_attention import sparse_attention_utils as tutils
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention as tss

torch.set_num_threads(2)

B, T, H, D = 2, 64, 2, 16
BLOCK = 16
FWD_TOL = 2e-4
GRAD_TOL = 2e-3

# (family, constructor kwargs): every family, both directions, per-head
# layouts and seeds
CONFIGS = [
    ("DenseSparsityConfig", {}),
    ("FixedSparsityConfig", dict(num_local_blocks=2, num_global_blocks=1)),
    ("FixedSparsityConfig", dict(num_local_blocks=2, attention="unidirectional")),
    ("FixedSparsityConfig", dict(num_local_blocks=2, horizontal_global_attention=True)),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1,
                                 different_layout_per_head=True,
                                 num_different_global_patterns=2)),
    ("VariableSparsityConfig", dict(num_random_blocks=1, local_window_blocks=[1, 2],
                                    global_block_indices=[0])),
    ("VariableSparsityConfig", dict(num_random_blocks=2, local_window_blocks=[2],
                                    global_block_indices=[1], global_block_end_indices=[3],
                                    different_layout_per_head=True, seed=5,
                                    attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(num_random_blocks=1, num_sliding_window_blocks=3,
                                   num_global_blocks=1)),
    ("BigBirdSparsityConfig", dict(num_random_blocks=1, num_sliding_window_blocks=3,
                                   different_layout_per_head=True, seed=3,
                                   attention="unidirectional")),
    ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=3,
                                        global_block_indices=[0])),
    ("LocalSlidingWindowSparsityConfig", dict(num_sliding_window_blocks=3)),
    ("LocalSlidingWindowSparsityConfig", dict(num_sliding_window_blocks=3,
                                              attention="bidirectional")),
]
IDS = [f"{name}-{i}" for i, (name, _) in enumerate(CONFIGS)]


def _configs(i):
    name, kw = CONFIGS[i]
    return (getattr(jsa, name)(num_heads=H, block=BLOCK, **kw),
            getattr(tsa, name)(num_heads=H, block=BLOCK, **kw))


def _causal(cfg):
    return getattr(cfg, "attention", "bidirectional") == "unidirectional"


def _qkv(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


def _torch(xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=IDS)
def test_layouts_equal_jax(i):
    jcfg, tcfg = _configs(i)
    for t in (T, 2 * T):
        want, got = jcfg.make_layout(t), tcfg.make_layout(t)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_layout_errors_match_jax():
    for mod in (jsa, tsa):
        with pytest.raises(ValueError):
            mod.DenseSparsityConfig(num_heads=H, block=BLOCK).make_layout(BLOCK + 1)
        with pytest.raises(ValueError):
            mod.FixedSparsityConfig(num_heads=H, num_local_blocks=3, num_global_blocks=2)
        with pytest.raises(ValueError):
            mod.BigBirdSparsityConfig(num_heads=H, block=BLOCK,
                                      num_sliding_window_blocks=9).make_layout(T)


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=IDS)
def test_kernel_path_matches_pallas_forward(i):
    """The plain B5 path (``block_sparse_attention`` on CPU tensors) against
    the Pallas forward kernel."""
    jcfg, tcfg = _configs(i)
    q, k, v = _qkv(i)
    causal = _causal(jcfg)
    want = jsa.block_sparse_attention(*map(jnp.asarray, (q, k, v)),
                                      jcfg.make_layout(T), block=BLOCK, causal=causal)
    bsa.launches_sparse_fwd = 0
    got = tsa.block_sparse_attention(*_torch((q, k, v)), tcfg.make_layout(T),
                                     block=BLOCK, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)
    assert bsa.launches_sparse_fwd == 0, "a CPU tensor must not count as a launch"


@pytest.mark.parametrize("i", [0, 2, 4, 6, 7, 8], ids=[IDS[i] for i in (0, 2, 4, 6, 7, 8)])
def test_kernel_path_gradients_match_jax(i):
    """Autograd through ``BlockSparseAttentionFunction`` (the plain B6/B7
    path) against ``jax.grad`` through the Pallas kernels."""
    jcfg, tcfg = _configs(i)
    q, k, v = _qkv(10 + i)
    causal = _causal(jcfg)
    jl = jcfg.make_layout(T)

    def loss(q, k, v):
        return jnp.sum(jsa.block_sparse_attention(q, k, v, jl, block=BLOCK,
                                                  causal=causal) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = _torch((q, k, v), grad=True)
    (tsa.block_sparse_attention(*leaves, tcfg.make_layout(T), block=BLOCK,
                                causal=causal) ** 2).sum().backward()
    for name, w, x in zip("qkv", want, leaves):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_function_backward_equals_autograd_of_the_reference():
    """``block_sparse_bwd`` against autograd through the plain forward."""
    _, tcfg = _configs(7)
    tables = bsa.build_index_tables(tcfg.make_layout(T), "cpu")
    q, k, v = _torch(_qkv(20), grad=True)
    do = torch.tensor(np.random.RandomState(21).randn(B, T, H, D).astype(np.float32))
    o, lse = bsa.block_sparse_attention_reference(q, k, v, tables.layout, block=BLOCK)
    o.backward(do)
    got = bsa.block_sparse_bwd(q.detach(), k.detach(), v.detach(), o.detach(), lse,
                               do, tables, block=BLOCK)
    for g, x in zip(got, (q, k, v)):
        torch.testing.assert_close(g, x.grad, rtol=1e-5, atol=1e-5)


def test_rows_without_a_visible_key():
    """A hand-made layout with an empty row, and a causal one whose first
    row sees only future blocks: o = 0 and lse = NEG_INF there, the other
    rows match the dense path, and the gradients are finite (0 on the empty
    rows' queries)."""
    layout = np.ones((1, 4, 4), dtype=np.int64)
    layout[0, 2] = 0                      # q-block 2 sees nothing
    causal_layout = np.tril(np.ones((1, 4, 4), dtype=np.int64))
    causal_layout[0, 0, 0] = 0            # q-block 0's only past block removed
    causal_layout[0, 0, 3] = 1            # ... and a future one added
    for lay, causal, empty in ((layout, False, 2), (causal_layout, True, 0)):
        tables = bsa.build_index_tables(lay, "cpu")
        q, k, v = _torch(_qkv(30), grad=True)
        o, lse = bsa.block_sparse_fwd(q, k, v, tables, block=BLOCK, causal=causal)
        rows = slice(empty * BLOCK, (empty + 1) * BLOCK)
        assert torch.equal(o[:, rows], torch.zeros_like(o[:, rows]))
        assert bool((lse[:, :, rows] == NEG_INF).all())
        ref = tsa.dense_blocksparse_attention(q, k, v, lay, block=BLOCK, causal=causal)
        keep = torch.ones(T, dtype=torch.bool)
        keep[rows] = False
        torch.testing.assert_close(o[:, keep], ref[:, keep], rtol=FWD_TOL, atol=FWD_TOL)
        tsa.block_sparse_attention(q, k, v, lay, block=BLOCK, causal=causal).sum().backward()
        for x in (q, k, v):
            assert bool(torch.isfinite(x.grad).all())
        assert torch.equal(q.grad[:, rows], torch.zeros_like(q.grad[:, rows]))


@pytest.mark.parametrize("i", range(len(CONFIGS)), ids=IDS)
def test_gather_and_dense_match_jax(i):
    jcfg, tcfg = _configs(i)
    q, k, v = _qkv(40 + i)
    causal = _causal(jcfg)
    jq = list(map(jnp.asarray, (q, k, v)))
    for jfn, tfn in ((jsa.gathered_blocksparse_attention, tsa.gathered_blocksparse_attention),
                     (jsa.dense_blocksparse_attention, tsa.dense_blocksparse_attention)):
        want = jfn(*jq, jcfg.make_layout(T), block=BLOCK, causal=causal)
        got = tfn(*_torch((q, k, v)), tcfg.make_layout(T), block=BLOCK, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                                   atol=FWD_TOL, err_msg=tfn.__name__)


@pytest.mark.parametrize("modes", [("add", "mul"), ("mul", "add")])
@pytest.mark.parametrize("i", [1, 5, 7], ids=[IDS[i] for i in (1, 5, 7)])
def test_gather_and_dense_with_masks_match_jax(i, modes):
    """Key padding and attention masks in both modes."""
    kpm_mode, am_mode = modes
    jcfg, tcfg = _configs(i)
    q, k, v = _qkv(50 + i)
    rng = np.random.RandomState(60 + i)
    if kpm_mode == "add":
        kpm = np.zeros((B, T), np.float32)
        kpm[:, T - 20:] = -1e9
    else:
        kpm = np.ones((B, T), np.float32)
        kpm[1, T - 9:] = 0.0
    am = (rng.rand(T, T) > 0.1).astype(np.float32)
    if am_mode == "add":
        am = np.where(am > 0, 0.0, -1e9).astype(np.float32)
    kw = dict(block=BLOCK, key_padding_mask_mode=kpm_mode, attn_mask_mode=am_mode)
    for jfn, tfn in ((jsa.gathered_blocksparse_attention, tsa.gathered_blocksparse_attention),
                     (jsa.dense_blocksparse_attention, tsa.dense_blocksparse_attention)):
        for masks in (dict(key_padding_mask=kpm), dict(attn_mask=am),
                      dict(key_padding_mask=kpm, attn_mask=am)):
            want = jfn(*map(jnp.asarray, (q, k, v)), jcfg.make_layout(T),
                       **{n: jnp.asarray(m) for n, m in masks.items()}, **kw)
            got = tfn(*_torch((q, k, v)), tcfg.make_layout(T),
                      **{n: torch.tensor(m) for n, m in masks.items()}, **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                                       atol=2e-3, err_msg=f"{tfn.__name__} {sorted(masks)}")


@pytest.mark.parametrize("masked", [False, True])
def test_gather_gradients_match_jax(masked):
    jcfg, tcfg = _configs(7)
    q, k, v = _qkv(70)
    kpm = np.zeros((B, T), np.float32)
    kpm[:, T - 20:] = -1e9
    jk = dict(key_padding_mask=jnp.asarray(kpm)) if masked else {}
    tk = dict(key_padding_mask=torch.tensor(kpm)) if masked else {}
    jl = jcfg.make_layout(T)

    def loss(q, k, v):
        return jnp.sum(jsa.gathered_blocksparse_attention(q, k, v, jl, block=BLOCK,
                                                          **jk) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = _torch((q, k, v), grad=True)
    (tsa.gathered_blocksparse_attention(*leaves, tcfg.make_layout(T), block=BLOCK,
                                        **tk) ** 2).sum().backward()
    for name, w, x in zip("qkv", want, leaves):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{name}")


def test_sparse_self_attention_routing():
    """gather by default; the config's kernel selector; pallas with a mask
    warns and takes the dense path; causal from the config's direction."""
    jcfg, tcfg = _configs(2)            # Fixed, unidirectional
    q, k, v = _qkv(80)
    tq = _torch((q, k, v))
    jq = list(map(jnp.asarray, (q, k, v)))
    kpm = np.zeros((B, T), np.float32)
    kpm[:, T // 2:] = -1e9

    att = tsa.SparseSelfAttention(tcfg, max_seq_length=T)
    assert att.impl == "gather"
    want = jsa.SparseSelfAttention(jcfg, max_seq_length=T)(*jq)
    np.testing.assert_allclose(att(*tq).numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    with pytest.raises(ValueError):
        att.get_layout(4 * T)
    with pytest.raises(ValueError):
        tsa.SparseSelfAttention(tcfg, impl="triton")

    sc = tutils.get_sparse_attention_config(
        {"mode": "fixed", "block": BLOCK, "num_local_blocks": 2,
         "attention": "unidirectional", "kernel": "pallas"}, num_heads=H)
    pallas = tsa.SparseSelfAttention(sc, max_seq_length=T)
    assert pallas.impl == "pallas"
    bsa.launches_sparse_fwd = 0
    np.testing.assert_allclose(pallas(*tq).numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    dense = tsa.dense_blocksparse_attention(*tq, sc.make_layout(T), block=BLOCK,
                                            causal=True, key_padding_mask=torch.tensor(kpm))
    with pytest.warns(UserWarning, match="DENSE"):
        masked = pallas(*tq, key_padding_mask=torch.tensor(kpm))
    torch.testing.assert_close(masked, dense)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tsa.SparseSelfAttention(sc, impl="dense", max_seq_length=T)(*tq)
    # an explicit causal=False overrides the config's direction
    bidir = pallas(*tq, causal=False)
    ref = tsa.dense_blocksparse_attention(*tq, sc.make_layout(T), block=BLOCK)
    torch.testing.assert_close(bidir, ref, rtol=FWD_TOL, atol=FWD_TOL)


def test_get_sparse_attention_config_matches_jax():
    block = {"mode": "bigbird", "block": 32, "num_random_blocks": 2, "seed": 7,
             "kernel": "pallas"}
    j = jutils.get_sparse_attention_config(dict(block), num_heads=4)
    t = tutils.get_sparse_attention_config(dict(block), num_heads=4)
    assert type(t).__name__ == type(j).__name__ == "BigBirdSparsityConfig"
    assert t.kernel_impl == j.kernel_impl == "pallas"
    np.testing.assert_array_equal(t.make_layout(256), j.make_layout(256))
    assert tutils.get_sparse_attention_config(t, num_heads=4) is t
    for bad, err, match in (({"mode": "banded"}, NotImplementedError, "mode 'banded'"),
                            ({"mode": "bigbird", "num_locl_blocks": 4}, ValueError,
                             "unknown keys"),
                            ({"mode": "fixed", "num_heads": 4}, ValueError, "unknown keys"),
                            ({"mode": "fixed", "kernel": "triton"}, ValueError,
                             "kernel must be")):
        for mod in (jutils, tutils):
            with pytest.raises(err, match=match):
                mod.get_sparse_attention_config(dict(bad), num_heads=2)


def test_apply_sparse_attention_refuses_models_without_the_field():
    class NoConfig(torch.nn.Module):
        pass

    with pytest.raises(NotImplementedError, match="sparse attention"):
        tutils.apply_sparse_attention(NoConfig(), {"mode": "fixed"})


def test_pad_to_block_size_roundtrip():
    ids = torch.arange(2 * 50, dtype=torch.int32).reshape(2, 50)
    pad_len, padded, mask = tutils.pad_to_block_size(16, ids)
    jpad, jpadded, jmask = jutils.pad_to_block_size(16, jnp.asarray(ids.numpy()))
    assert pad_len == jpad == 14 and padded.shape == (2, 64)
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jpadded))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert bool(mask[:, :50].all()) and not bool(mask[:, 50:].any())
    assert tutils.unpad_sequence_output(pad_len, padded[..., None]).shape == (2, 50, 1)
    pad_len2, same, m2 = tutils.pad_to_block_size(16, padded, mask)
    assert pad_len2 == 0 and same is padded and m2 is mask


def test_index_tables_and_their_bounded_cache():
    _, tcfg = _configs(8)               # BigBird, a layout per head
    layout = tcfg.make_layout(T)
    tables = bsa.build_index_tables(layout, "cpu")
    for h in range(H):
        for r in range(T // BLOCK):
            n = int(tables.kcnt[h, r])
            assert tables.kidx[h, r, :n].tolist() == np.nonzero(layout[h, r])[0].tolist()
            assert bool((tables.kidx[h, r, n:] == -1).all())
            n = int(tables.qcnt[h, r])
            assert tables.qidx[h, r, :n].tolist() == np.nonzero(layout[h, :, r])[0].tolist()
            assert bool((tables.qidx[h, r, n:] == -1).all())
    assert tables.kidx.dtype == torch.int32 and tables.kidx.shape[0] == H
    # the grid orders: every row (korder) and every column (qorder) once
    nb = T // BLOCK
    for order, cnt in ((tables.korder, tables.kcnt), (tables.qorder, tables.qcnt)):
        assert order.dtype == torch.int32 and sorted(order.tolist()) == list(range(H * nb))
        assert torch.equal(order, torch.from_numpy(bsa.row_order(cnt.numpy())))
    tss._OP_CACHE.clear()
    assert tss._build_index_tables(layout, H, BLOCK, "cpu") is \
        tss._build_index_tables(layout, H, BLOCK, "cpu")
    for seed in range(tss._OP_CACHE_MAX + 3):
        lay = np.random.RandomState(seed).randint(0, 2, size=(1, 8, 8))
        tss._build_index_tables(lay, H, BLOCK, "cpu")
    assert len(tss._OP_CACHE) == tss._OP_CACHE_MAX
    with pytest.raises(ValueError, match="head layouts"):
        tss._build_index_tables(np.ones((3, 4, 4)), H, BLOCK, "cpu")


def test_card_only_checks_name_the_shape():
    """What a CUDA tensor of an unsupported shape meets (the check runs
    before any launch, so it is reachable on the CPU)."""
    for shape, dtype, block, match in (((1, 64, 2, 16), torch.bfloat16, 16, "head_dim 16"),
                                       ((1, 64, 2, 64), torch.float16, 16, "float16"),
                                       ((1, 48, 2, 64), torch.bfloat16, 48, "block 48")):
        with pytest.raises(ValueError, match=match):
            bsa._check_card(torch.empty(shape, dtype=dtype), block)
    q = torch.empty((1, 64, 2, 64))
    with pytest.raises(ValueError, match="covers"):
        bsa.block_sparse_fwd(q, q, q, bsa.build_index_tables(np.ones((1, 2, 2)), "cpu"),
                             block=16)


# ---------------------------------------------------------------------------
# the geometry of the card's B5 kernel: block 128, D 64, T 1024
# ---------------------------------------------------------------------------
GEO_B, GEO_T, GEO_H, GEO_D, GEO_BLOCK = 1, 1024, 2, 64, 128
GEO_CONFIGS = {
    "bigbird": dict(num_random_blocks=1, num_sliding_window_blocks=3, num_global_blocks=1),
    "bigbird_per_head": dict(num_random_blocks=1, num_sliding_window_blocks=3,
                             num_global_blocks=1, different_layout_per_head=True, seed=2),
}


def _jax_fwd_with_lse(q, k, v, layout, block, causal):
    """o [B, T, H, D] and lse [B, H, T] from the Pallas forward kernel, as
    ``_build_op``'s forward calls it."""
    b, t, h, d = q.shape
    kidx, n_k, _, _ = jss._build_index_tables(np.asarray(layout), h)
    hk, nq, _, width_k = kidx.shape

    def flat(x):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)

    o, lse = pl.pallas_call(
        functools.partial(jss._fwd_kernel, scale=1.0 / math.sqrt(d), causal=causal,
                          block=block, width_k=width_k, n_k=n_k),
        grid=(b * h, nq),
        in_specs=[pl.BlockSpec((None, block, d), lambda i, j: (i, j, 0)),
                  pl.BlockSpec((None, t, d), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((None, t, d), lambda i, j: (i, 0, 0)),
                  pl.BlockSpec((None, None, jss.IDX_SUBLANES, width_k),
                               lambda i, j: (i % hk, j, 0, 0))],
        out_specs=[pl.BlockSpec((None, block, d), lambda i, j: (i, j, 0)),
                   pl.BlockSpec((None, block, LSE_LANES), lambda i, j: (i, j, 0))],
        out_shape=[jax.ShapeDtypeStruct((b * h, t, d), jnp.float32),
                   jax.ShapeDtypeStruct((b * h, t, LSE_LANES), jnp.float32)],
        interpret=jss._interpret(),
    )(flat(q), flat(k), flat(v), jnp.asarray(kidx))
    o = np.asarray(o).reshape(b, h, t, d).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[..., 0].reshape(b, h, t)


@pytest.mark.parametrize("attention", ["bidirectional", "unidirectional"])
@pytest.mark.parametrize("name", sorted(GEO_CONFIGS))
def test_block128_geometry_matches_pallas(name, attention):
    """Forward, lse and gradients of the plain B5-B7 path against the
    Pallas kernels at block 128, D 64, T 1024."""
    kw = dict(GEO_CONFIGS[name], attention=attention)
    jl = jsa.BigBirdSparsityConfig(num_heads=GEO_H, block=GEO_BLOCK, **kw).make_layout(GEO_T)
    tl = tsa.BigBirdSparsityConfig(num_heads=GEO_H, block=GEO_BLOCK, **kw).make_layout(GEO_T)
    np.testing.assert_array_equal(tl, jl)
    causal = attention == "unidirectional"
    rng = np.random.RandomState(90 + len(name) + causal)
    q, k, v = (rng.randn(GEO_B, GEO_T, GEO_H, GEO_D).astype(np.float32) for _ in range(3))

    o_jax, lse_jax = _jax_fwd_with_lse(q, k, v, jl, GEO_BLOCK, causal)
    tables = bsa.build_index_tables(tl, "cpu")
    o, lse = bsa.block_sparse_fwd(*_torch((q, k, v)), tables, block=GEO_BLOCK, causal=causal)
    np.testing.assert_allclose(o.numpy(), o_jax, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_jax, rtol=FWD_TOL, atol=FWD_TOL)

    def loss(q, k, v):
        return jnp.sum(jsa.block_sparse_attention(q, k, v, jl, block=GEO_BLOCK,
                                                  causal=causal) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = _torch((q, k, v), grad=True)
    (tsa.block_sparse_attention(*leaves, tl, block=GEO_BLOCK, causal=causal) ** 2).sum().backward()
    for n, w, x in zip("qkv", want, leaves):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"d{n}")


# ---------------------------------------------------------------------------
# The grid orders: B5 and B6 take the rows, B7 the columns, longest first
# ---------------------------------------------------------------------------
def _bert_layout():
    """BERT-Large's BigBird layout on the card's main path: [16, 32, 32]."""
    return tsa.BigBirdSparsityConfig(num_heads=16, block=128, num_random_blocks=1,
                                     num_sliding_window_blocks=3,
                                     num_global_blocks=1).make_layout(4096)


ORDER_LAYOUTS = [(IDS[i], i) for i in range(len(CONFIGS))] + [("bert_large_bigbird", None)]


@pytest.mark.parametrize("i", [i for _, i in ORDER_LAYOUTS], ids=[n for n, _ in ORDER_LAYOUTS])
def test_row_order_is_longest_first_over_every_row(i):
    layout = _bert_layout() if i is None else _configs(i)[1].make_layout(4 * T)
    counts = (layout != 0).sum(-1)
    order = bsa.row_order(counts)
    flat = counts.reshape(-1)
    assert order.dtype == np.int32 and sorted(order.tolist()) == list(range(flat.size))
    assert (np.diff(flat[order]) <= 0).all()
    # ties keep the rows' own order
    assert all(a < b for a, b in zip(order, order[1:]) if flat[a] == flat[b])
    tables = bsa.build_index_tables(layout, "cpu")
    assert torch.equal(tables.korder, torch.from_numpy(order))
    # B7's column order: the same rule over the column counts
    col_counts = (layout != 0).sum(-2)
    assert torch.equal(tables.qorder, torch.from_numpy(bsa.row_order(col_counts)))
    col_flat = col_counts.reshape(-1)
    assert (np.diff(col_flat[tables.qorder.numpy()]) <= 0).all()
    if i is None:                      # each head's global row and column first
        assert order[:16].tolist() == [32 * h for h in range(16)]
        assert tables.qorder[:16].tolist() == [32 * h for h in range(16)]
