"""The port's compressed and bucketed exchange functions against the JAX
package's: ``ops/quantizer.py``, ``comm/compressed.py``,
``comm/bucketed.py``, ``runtime/comm/coalesced_collectives.py`` and the
1-bit ``compressed_allreduce`` (``runtime/fp16/onebit/adam.py``). The
cases mirror ``tests/unit/test_compressed_comm.py``,
``test_bucketed_comm.py`` and ``test_onebit.py``.

The local functions run in this process on the same numpy inputs as the
JAX ones. The collectives run on 2 gloo ranks (4 for the hierarchical
exchange and the sub-groups), child processes of this test in
``test_torch_zero.py``'s pattern (``python
tests/test_torch_compressed_comm.py --worker ...``, torch only), against
the JAX functions under ``shard_map`` on as many virtual CPU devices.

Tolerances: the int8 codes and scales are the JAX ones bit for bit (the
port takes a constant divisor's reciprocal as compiled XLA does). The
values built from them are not, quite: compiled XLA contracts ``q * s``
into the sum of the dequantized copies and into the residual ``x - q * s``
(one rounding, a fused multiply-add), where PyTorch rounds the product and
the sum apart, so a sum or a residual may differ by an ulp, and a phase-2
code at a rounding boundary may then flip. The int8 exchange (results and
residuals) is therefore held to one quantisation step of each block (its
scale) per element, with most elements asserted bit for bit; the f32
bucketed exchange, a sum with no product, is bit-identical. The 1-bit
exchange takes its scale as the mean of ``|x|``, a reduction whose order
differs between XLA and PyTorch: held to one sign-compression step (twice
the largest scale) per element and 1e-5 relative. The bf16 wire is held to
0.05 absolute, as the JAX test holds it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
BLOCK = 128


def _tree(seed, w):
    """Per-worker gradient leaves with a leading worker axis: mixed sizes
    (the JAX test's ``_tree``, in ``jax.tree.flatten`` order)."""
    rng = np.random.RandomState(seed)
    return [rng.randn(w, 7).astype(np.float32),        # dense/bias
            rng.randn(w, 13, 7).astype(np.float32),    # dense/kernel
            rng.randn(w, 130).astype(np.float32)]      # head


def _inputs(w):
    rng = np.random.RandomState(0)
    return {
        "x4096": rng.randn(w, 4096).astype(np.float32),
        "x1000": rng.randn(w, 1000).astype(np.float32),
        "se1000": (rng.randn(w, (1000 + (-1000) % (w * BLOCK)) // w)
                   * 0.01).astype(np.float32),
        "tree": _tree(3, w),
        "onebit_x": rng.randn(w, 1000).astype(np.float32),
        "onebit_we": (rng.randn(w, 1000) * 0.1).astype(np.float32),
        "onebit_se": (rng.randn(w, 1000 // w) * 0.1).astype(np.float32),
        "coalesced": [rng.randn(w, 5).astype(np.float32),
                      rng.randn(w, 3, 3).astype(np.float32)],
    }


# ---------------------------------------------------------------------------
# the child process: torch and the port only
# ---------------------------------------------------------------------------
def _port_cases(rank, w, inp):
    from deepspeed_tpu_torch.comm import bucketed as bk
    from deepspeed_tpu_torch.comm.compressed import quantized_all_reduce
    from deepspeed_tpu_torch.comm.logging import comms_logger
    from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc
    from deepspeed_tpu_torch.runtime.fp16.onebit import compressed_allreduce

    def mine(a):
        return torch.tensor(a[rank])

    out = {}
    out["q4096"] = quantized_all_reduce(mine(inp["x4096"]), "dp",
                                        block=256)
    out["q1000_err"] = quantized_all_reduce(
        mine(inp["x1000"]), "dp", block=BLOCK, return_error=True,
        server_error=mine(inp["se1000"]))
    leaves = [mine(t) for t in inp["tree"]]
    plan = bk.plan_for_tree(leaves, bucket_mb=500 / (1 << 20))
    out["plan"] = plan
    comms_logger.reset()
    comms_logger.enabled = True
    out["bucketed32"] = bk.bucketed_all_reduce(leaves, "dp", plan, mean=True,
                                               log_name="gx_test")
    out["records32"] = comms_logger.snapshot()
    per_leaf = []
    for leaf in leaves:
        t = leaf.clone()
        torch.distributed.all_reduce(t)
        per_leaf.append(t / w)
    out["per_leaf"] = per_leaf
    comms_logger.reset()
    out["bucketed16"] = bk.bucketed_all_reduce(
        leaves, "dp", wire_dtype=torch.bfloat16, mean=True)
    out["quantized_bucketed"] = bk.bucketed_quantized_all_reduce(
        leaves, "dp", plan, block=BLOCK, log_name="q_gx")
    out["records_q"] = comms_logger.snapshot()
    one = bk.assign_buckets([l.numel() for l in leaves], 1 << 40)
    out["quantized_one_bucket"] = bk.bucketed_quantized_all_reduce(
        leaves, "dp", one, block=BLOCK)
    out["onebit"] = compressed_allreduce(
        mine(inp["onebit_x"]), mine(inp["onebit_we"]),
        mine(inp["onebit_se"]), "dp", n_valid=997)
    out["coalesced_rs"] = cc.reduce_scatter_coalesced(
        [mine(t) for t in inp["coalesced"]], "dp")
    out["coalesced_ag"] = cc.all_gather_coalesced(
        [mine(t).reshape(-1) for t in inp["coalesced"]], "dp")
    comms_logger.enabled = False
    comms_logger.reset()
    return out


def _port_cases4(rank, w, inp):
    from deepspeed_tpu_torch.comm import bucketed as bk
    from deepspeed_tpu_torch.comm.compressed import quantized_all_reduce
    from deepspeed_tpu_torch.comm.logging import comms_logger

    leaves = [torch.tensor(t[rank]) for t in inp["tree"]]
    plan = bk.plan_for_tree(leaves, bucket_mb=500 / (1 << 20))
    comms_logger.reset()
    comms_logger.enabled = True
    out = {"hier": bk.hierarchical_all_reduce(
        leaves, "dp", 2, plan, block=BLOCK, wire_dtype=torch.bfloat16,
        mean=True, log_name="h")}
    out["levels"] = dict(comms_logger.level_bytes)
    out["records"] = comms_logger.snapshot()
    comms_logger.enabled = False
    comms_logger.reset()
    out["groups_q"] = quantized_all_reduce(
        torch.tensor(inp["x1000"][rank]), "dp", block=BLOCK,
        axis_index_groups=[[0, 2], [1, 3]])
    return out


def _worker(argv):
    spec, rank, world, url, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    from datetime import timedelta

    from deepspeed_tpu_torch import comm

    torch.set_num_threads(1)
    comm.init_distributed(init_method=url, rank=rank, world_size=world,
                          timeout=timedelta(seconds=GROUP_TIMEOUT_S),
                          device_type="cpu")
    inp = torch.load(spec, weights_only=False)
    cases = _port_cases if world == 2 else _port_cases4
    torch.save(cases(rank, world, inp), out)
    comm.destroy_distributed()
    return 0


def run_ranks(inp, tmp_path, world):
    tmp_path = str(tmp_path)
    spec = os.path.join(tmp_path, "inputs.pt")
    torch.save(inp, spec)
    rdv = os.path.join(tmp_path, "rendezvous")
    outs = [os.path.join(tmp_path, f"rank{r}.pt") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", spec, str(r),
         str(world), f"file://{rdv}", outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1")) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    inp = _inputs(2)
    return inp, run_ranks(inp, tmp_path_factory.mktemp("cx2"), 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    inp = _inputs(4)
    return inp, run_ranks(inp, tmp_path_factory.mktemp("cx4"), 4)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------
def _mesh(w):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:w]), ("dp",))


def _shard_map(fn, w, n_in, out_specs):
    import jax
    from jax.sharding import PartitionSpec as P

    return jax.jit(jax.shard_map(fn, mesh=_mesh(w), in_specs=(P("dp"),) * n_in,
                                 out_specs=out_specs, check_vma=False))


def assert_within_one_step(got, want, block, scale_of=None,
                           min_equal=0.25):
    """``got`` against ``want``, elementwise, to one int8 step of each block
    of ``block`` elements: the block's scale (``max|scale_of|`` / 127 over
    the block, ``scale_of`` defaulting to ``want``), and at least
    ``min_equal`` of the elements bit for bit."""
    got, want = np.asarray(got).ravel(), np.asarray(want).ravel()
    ref = np.abs(want if scale_of is None else np.asarray(scale_of).ravel())
    pad = (-len(want)) % block
    step = np.repeat(np.pad(ref, (0, pad)).reshape(-1, block).max(1) / 127,
                     block)[:len(want)]
    diff = np.abs(got - want)
    assert np.all(diff <= step * 1.01 + 1e-30), float((diff / step).max())
    assert np.mean(got == want) >= min_equal, np.mean(got == want)


def assert_residual_within_one_step(got, want, block):
    """Residuals of int8 blocks: a residual is at most half a step, so a
    step is at least twice the largest residual of its block (either
    side's)."""
    both = np.maximum(np.abs(np.asarray(got)), np.abs(np.asarray(want)))
    assert_within_one_step(got, want, block, scale_of=both * 2 * 127,
                           min_equal=0.0)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x)


def _leaves(tree):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# local functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("bits,groups", [(8, 1), (8, 6), (4, 3)])
def test_quantize_dequantize_match_jax(symmetric, bits, groups):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.ops import quantizer as jq
    from deepspeed_tpu_torch.ops import quantizer as tq

    x = np.random.RandomState(bits + groups).randn(6, 35).astype(np.float32)
    # compiled, as every JAX caller runs it (XLA multiplies by the
    # reciprocal of a constant divisor)
    jqv, js, jz = jax.jit(jq.quantize, static_argnums=(1, 2, 3))(
        jnp.asarray(x), bits, groups, symmetric)
    q, s, z = tq.quantize(torch.tensor(x), bits, groups, symmetric)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if not symmetric:
        np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(
        tq.dequantize(q, s, z, bits).numpy(),
        np.asarray(jq.dequantize(jqv, js, jz, bits)))
    # compiled, the asymmetric round trip's (q + c) * s + z is one fused
    # multiply-add: an ulp apart
    np.testing.assert_allclose(
        tq.fake_quantize(torch.tensor(x), bits, groups, symmetric).numpy(),
        np.asarray(jax.jit(jq.fake_quantize, static_argnums=(1, 2, 3))(
            jnp.asarray(x), bits, groups, symmetric)), rtol=1e-6,
        atol=1e-7)


def test_blockwise_and_per_column_match_jax():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.ops import quantizer as jq
    from deepspeed_tpu_torch.ops import quantizer as tq

    rng = np.random.RandomState(5)
    x = rng.randn(3, 4, 64).astype(np.float32)
    jqv, js = jax.jit(jq.quantize_blockwise, static_argnums=1)(
        jnp.asarray(x), 16)
    q, s = tq.quantize_blockwise(torch.tensor(x), 16)
    assert s.shape == (3, 4, 4)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.dequantize_blockwise(q, s).numpy(),
        np.asarray(jq.dequantize_blockwise(jqv, js)))
    w = rng.randn(24, 10).astype(np.float32)
    jwq, jws = jax.jit(jq.quantize_weight_per_column)(jnp.asarray(w))
    wq, ws = tq.quantize_weight_per_column(torch.tensor(w))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    for a, b in zip(tq.quantize_weight_per_column_np(w[None]),
                    jq.quantize_weight_per_column_np(w[None])):
        np.testing.assert_array_equal(a, b)
    xin = rng.randn(5, 24).astype(np.float32)
    np.testing.assert_allclose(
        tq.int8_matmul(torch.tensor(xin), wq, ws,
                       preferred_dtype=torch.float32).numpy(),
        np.asarray(jq.int8_matmul(jnp.asarray(xin), jwq, jws,
                                  preferred_dtype=jnp.float32)),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="per-output-column"):
        tq.int8_matmul(torch.tensor(xin), wq, ws[:3])


def test_quantization_error_matches_jax():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm.compressed import quantization_error as jqe
    from deepspeed_tpu_torch.comm.compressed import quantization_error

    x = np.random.RandomState(3).randn(600).astype(np.float32)
    # x - q * s, a fused multiply-add when compiled
    np.testing.assert_allclose(
        quantization_error(torch.tensor(x), 128).numpy(),
        np.asarray(jax.jit(jqe, static_argnums=1)(jnp.asarray(x), 128)),
        rtol=0, atol=2e-7)


@pytest.mark.parametrize("sizes,budget", [
    ([100, 50, 200, 10], 600), ([5, 6, 7], 0), ([5, 6, 7], 1 << 40),
    ([1000, 1, 1, 1000, 3], 4004)])
def test_bucket_plans_match_jax(sizes, budget):
    from deepspeed_tpu.comm import bucketed as jb
    from deepspeed_tpu_torch.comm import bucketed as tb

    mine, ref = tb.assign_buckets(sizes, budget), jb.assign_buckets(
        sizes, budget)
    assert mine.bucket_leaves == ref.bucket_leaves
    assert mine.bucket_sizes() == ref.bucket_sizes()
    assert mine.num_buckets == ref.num_buckets


def test_plan_for_tree_matches_jax():
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.comm import bucketed as jb
    from deepspeed_tpu_torch.comm import bucketed as tb

    shapes = [(7,), (13, 7), (130,), (64, 64)]
    tree = {f"l{i}": jax.ShapeDtypeStruct(s, jnp.float32)
            for i, s in enumerate(shapes)}
    for mb in (0.0, 500 / (1 << 20), 1.0):
        ref = jb.plan_for_tree(tree, mb)
        got = tb.plan_for_tree([torch.zeros(s) for s in shapes], mb)
        assert got.bucket_leaves == ref.bucket_leaves
        assert tb.plan_for_tree(shapes, mb) == got


@pytest.mark.parametrize("world,slices", [(8, 2), (4, 2), (4, 4), (6, 3)])
def test_hierarchy_groups_match_jax(world, slices):
    from deepspeed_tpu.comm import bucketed as jb
    from deepspeed_tpu_torch.comm import bucketed as tb

    assert tb.hierarchy_groups(world, slices) == jb.hierarchy_groups(
        world, slices)
    with pytest.raises(ValueError, match="equal slices"):
        tb.hierarchy_groups(world, world + 1)


def test_shard_layout_and_padded_length_match_jax():
    from deepspeed_tpu.runtime.comm import coalesced_collectives as jcc
    from deepspeed_tpu.runtime.fp16.onebit.adam import \
        padded_length as jpl
    from deepspeed_tpu_torch.runtime.comm import coalesced_collectives as cc
    from deepspeed_tpu_torch.runtime.fp16.onebit import padded_length

    sizes = [5, 9, 1, 130]
    assert cc.shard_layout(sizes, 4) == jcc.shard_layout(sizes, 4)
    assert cc.shard_layout([torch.zeros(n) for n in sizes], 4) == \
        jcc.shard_layout(sizes, 4)
    for n in (1, 7, 8, 1001):
        for k in (1, 2, 8):
            assert padded_length(n, k) == jpl(n, k)


@pytest.mark.parametrize("n_valid", [None, 990])
def test_sign_compression_matches_jax(n_valid):
    """``_compress``: the signs bit for bit, the scale and residuals to the
    f32 rounding of the mean's reduction order."""
    import jax.numpy as jnp

    from deepspeed_tpu.runtime.fp16.onebit.adam import _compress as jc
    from deepspeed_tpu_torch.runtime.fp16.onebit.adam import _compress

    rng = np.random.RandomState(9)
    x, e = rng.randn(1000).astype(np.float32), rng.randn(1000).astype(
        np.float32) * 0.1
    mask = None if n_valid is None else jnp.arange(1000) < n_valid
    js, jscale, jerr = jc(jnp.asarray(x), jnp.asarray(e), mask)
    s, scale, err = _compress(torch.tensor(x), torch.tensor(e), n_valid)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), atol=1e-6)


# ---------------------------------------------------------------------------
# collectives on 2 ranks
# ---------------------------------------------------------------------------
def test_quantized_all_reduce_bit_identical(two):
    """Aligned (4096, block 256) and ragged (1000, block 128, with the
    returned worker residual and a server residual) against JAX."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm.compressed import quantized_all_reduce as jqar

    inp, ranks = two
    f = _shard_map(lambda x: jqar(x[0], "dp", block=256), 2, 1, P())
    want = np.asarray(f(jnp.asarray(inp["x4096"])))
    g = _shard_map(lambda x, s: tuple(t[None] for t in jqar(
        x[0], "dp", block=BLOCK, return_error=True, server_error=s[0])),
        2, 2, (P("dp"),) * 3)
    out, err, se = (np.asarray(t) for t in g(jnp.asarray(inp["x1000"]),
                                             jnp.asarray(inp["se1000"])))
    exact = inp["x4096"].sum(0)
    for rank, got in enumerate(ranks):
        assert_within_one_step(got["q4096"].numpy(), want, 256)
        assert np.abs(want - exact).max() < 0.05 * np.abs(exact).max()
        o, e, s = got["q1000_err"]
        assert_within_one_step(o.numpy(), out[rank], BLOCK)
        assert_residual_within_one_step(e.numpy(), err[rank], BLOCK)
        assert_residual_within_one_step(s.numpy(), se[rank], BLOCK)


def test_bucketed_fp32_bit_identical_to_per_leaf_and_jax(two):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm import bucketed as jb

    inp, ranks = two
    tree = [jnp.asarray(t) for t in inp["tree"]]
    plan = ranks[0]["plan"]
    jplan = jb.assign_buckets([t[0].size for t in tree],
                              int(500 / (1 << 20) * 1024 * 1024))
    assert plan.bucket_leaves == jplan.bucket_leaves
    assert plan.num_buckets > 1
    f = jax.jit(jax.shard_map(
        lambda *t: tuple(jb.bucketed_all_reduce(
            [x[0] for x in t], "dp", jplan, mean=True)),
        mesh=_mesh(2), in_specs=(P("dp"),) * 3, out_specs=(P(),) * 3,
        check_vma=False))
    want = [np.asarray(x) for x in f(*tree)]
    for got in ranks:
        for a, b, c in zip(got["bucketed32"], got["per_leaf"], want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a.numpy(), c)


def test_bucketed_bf16_wire_close_and_dtype_kept(two):
    inp, ranks = two
    exact = [t.mean(0) for t in inp["tree"]]
    for got in ranks:
        for g, r in zip(got["bucketed16"], exact):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), r, atol=0.05)


def test_bucketed_quantized_matches_jax(two):
    """Per-bucket int8 exchange (results and per-bucket residuals) against
    JAX's; one all-covering bucket covers the monolithic flat exchange."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm import bucketed as jb
    from deepspeed_tpu.comm.compressed import server_shard_length

    inp, ranks = two
    tree = [jnp.asarray(t) for t in inp["tree"]]
    plan = jb.assign_buckets([t[0].size for t in tree],
                             int(500 / (1 << 20) * 1024 * 1024))
    nb = plan.num_buckets

    def body(*t):
        out, we, se = jb.bucketed_quantized_all_reduce(
            [x[0] for x in t], "dp", plan, block=BLOCK)
        return (tuple(out), tuple(e[None] for e in we),
                tuple(s[None] for s in se))

    f = jax.jit(jax.shard_map(
        body, mesh=_mesh(2), in_specs=(P("dp"),) * 3,
        out_specs=((P(),) * 3, (P("dp"),) * nb, (P("dp"),) * nb),
        check_vma=False))
    out, we, se = f(*tree)
    for rank, got in enumerate(ranks):
        g_out, g_we, g_se = got["quantized_bucketed"]
        for idxs in plan.bucket_leaves:
            assert_within_one_step(
                np.concatenate([g_out[i].numpy().ravel() for i in idxs]),
                np.concatenate([np.asarray(out[i]).ravel() for i in idxs]),
                BLOCK)
        for b, n in enumerate(plan.bucket_sizes()):
            assert_residual_within_one_step(g_we[b].numpy(),
                                            np.asarray(we[b])[rank], BLOCK)
            assert_residual_within_one_step(g_se[b].numpy(),
                                            np.asarray(se[b])[rank], BLOCK)
            assert g_se[b].numel() == server_shard_length(n, 2, BLOCK)
        # the one-bucket plan against the monolithic flat exchange
        one, _, _ = got["quantized_one_bucket"]
        flat = torch.cat([t.reshape(-1) for t in one])
        assert flat.numel() == sum(t[0].size for t in inp["tree"])


def test_wire_records_per_bucket(two):
    """One record per bucket, named ``<log_name>.bucket<i>``, in the
    wire dtype's bytes; the int8 exchange's payload and ``.scales``
    sideband per bucket."""
    _, ranks = two
    got = ranks[0]
    plan = got["plan"]
    for b, n in enumerate(plan.bucket_sizes()):
        rec = got["records32"][f"gx_test.bucket{b}"]
        assert rec["count"] == 1 and rec["bytes"] == 4 * n
        assert f"q_gx.bucket{b}" in got["records_q"]
        assert f"q_gx.bucket{b}.scales" in got["records_q"]


def test_onebit_compressed_allreduce_with_padding(two):
    """The 1-bit exchange of a padded tensor (997 of 1000 valid) against
    JAX's: within one sign-compression step everywhere, most elements bit
    for bit (the scales are means in another reduction order)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.runtime.fp16.onebit import compressed_allreduce as jca

    inp, ranks = two
    f = _shard_map(lambda x, e, s: tuple(t[None] for t in jca(
        x[0], e[0], s[0], "dp", n_valid=997)), 2, 3, (P("dp"),) * 3)
    want = [np.asarray(t) for t in f(jnp.asarray(inp["onebit_x"]),
                                     jnp.asarray(inp["onebit_we"]),
                                     jnp.asarray(inp["onebit_se"]))]
    for rank, got in enumerate(ranks):
        res, we, se = (t.numpy() for t in got["onebit"])
        step = 2 * np.abs(want[0][rank]).max()
        for a, b in ((res, want[0][rank]), (we, want[1][rank]),
                     (se, want[2][rank])):
            assert np.abs(a - b).max() <= step
        assert np.mean(np.sign(res) == np.sign(want[0][rank])) == 1.0
        np.testing.assert_allclose(res, want[0][rank], rtol=1e-5)
        assert np.all(we[997:] == 0)


def test_coalesced_match_jax(two):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.runtime.comm import coalesced_collectives as jcc

    inp, ranks = two
    ts = [jnp.asarray(t) for t in inp["coalesced"]]
    rs = jax.jit(jax.shard_map(
        lambda a, b: jcc.reduce_scatter_coalesced([a[0], b[0]], "dp")[None],
        mesh=_mesh(2), in_specs=(P("dp"),) * 2, out_specs=P("dp"),
        check_vma=False))(*ts)
    ag = jax.jit(jax.shard_map(
        lambda a, b: tuple(jcc.all_gather_coalesced(
            [a[0].reshape(-1), b[0].reshape(-1)], "dp")),
        mesh=_mesh(2), in_specs=(P("dp"),) * 2, out_specs=(P(), P()),
        check_vma=False))(*ts)
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["coalesced_rs"].numpy(),
                                      np.asarray(rs)[rank])
        for a, b in zip(got["coalesced_ag"], ag):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# 4 ranks: the hierarchical exchange and sub-groups
# ---------------------------------------------------------------------------
def test_hierarchical_four_ranks_two_slices(four):
    """bf16 reduce-scatter within each slice, the int8 exchange across
    slices, the all-gather back: against JAX's (one int8 step of the DCN
    leg plus bf16 rounding) and the exact mean; the wire records tagged
    "ici" and "dcn"."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm import bucketed as jb

    inp, ranks = four
    tree = [jnp.asarray(t) for t in inp["tree"]]
    plan = jb.assign_buckets([t[0].size for t in tree],
                             int(500 / (1 << 20) * 1024 * 1024))
    f = jax.jit(jax.shard_map(
        lambda *t: tuple(jb.hierarchical_all_reduce(
            [x[0] for x in t], "dp", 2, plan, block=BLOCK, mean=True,
            log_name="h")),
        mesh=_mesh(4), in_specs=(P("dp"),) * 3, out_specs=(P(),) * 3,
        check_vma=False))
    want = [np.asarray(x) for x in f(*tree)]
    exact = [t.mean(0) for t in inp["tree"]]
    for got in ranks:
        for a, b, e in zip(got["hier"], want, exact):
            a = a.numpy()
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=0.02 * np.abs(e).max())
            np.testing.assert_allclose(a, e, atol=0.05)
        assert got["levels"]["ici"] > 0 and got["levels"]["dcn"] > 0
        names = set(got["records"])
        for b in range(plan.num_buckets):
            assert {f"h.bucket{b}.ici", f"h.bucket{b}.dcn"} <= names


def test_quantized_all_reduce_over_index_groups(four):
    """``axis_index_groups`` [[0, 2], [1, 3]] (the DCN groups of 2 slices):
    each rank sums with its group only, as JAX does."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.comm.compressed import quantized_all_reduce as jqar

    inp, ranks = four
    f = jax.jit(jax.shard_map(
        lambda x: jqar(x[0], "dp", block=BLOCK,
                       axis_index_groups=[[0, 2], [1, 3]])[None],
        mesh=_mesh(4), in_specs=(P("dp"),), out_specs=P("dp"),
        check_vma=False))
    want = np.asarray(f(jnp.asarray(inp["x1000"])))
    for rank, got in enumerate(ranks):
        assert_within_one_step(got["groups_q"].numpy(), want[rank], BLOCK)
        partner = rank ^ 2
        exact = inp["x1000"][rank] + inp["x1000"][partner]
        assert np.abs(want[rank] - exact).max() < 0.05 * np.abs(exact).max()


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.exit(_worker(sys.argv[2:]))
