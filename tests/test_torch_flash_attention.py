"""The port's flash attention, forward and backward, against the JAX
package's.

``deepspeed_tpu_torch.ops.cuda.flash_attention`` on CPU tensors runs its plain
PyTorch versions; the JAX side runs the Pallas kernels in interpret mode, as
``tests/unit/test_ops.py`` does. Both see the same numpy inputs. In f32 only
the order of the sums differs (atol 1e-5 on o, lse and on gradients of order
1). In fp16 the JAX kernels round P (and, backward, dS) to fp16 before the
second products and both sides round o and the gradients to fp16 (11
significant bits): o may differ by two fp16 ulps at |o| < 4 (atol 4e-3),
gradients by 2e-3 of their largest entry; lse is f32 on both sides (1e-5).
The cases cover the head dims of the models the card runs (D 64 and 128)
and T that are not a multiple of 128 (192, and 320 at D 128 with segments:
the wgmma dq kernel's 128-row blocks end inside a block there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.common import LSE_LANES
from deepspeed_tpu.ops.pallas.flash_attention import _fwd
from deepspeed_tpu.ops.pallas.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)

ATOL = 1e-5
# per input dtype: o, lse (absolute) and gradients (f32 absolute, fp16 over
# their largest entry); the module note gives the reasons
TOL = {"float32": (ATOL, ATOL, ATOL), "float16": (4e-3, ATOL, 2e-3)}


def _cases():
    """(causal, t, with_segments, head_dim, dtype) with their test ids: the
    D 32 f32 grid keeps its ids; D 64 / 128, fp16 and T 192 and 320 are
    added."""
    cases = [pytest.param(c, t, s, 32, "float32", id=f"{c}-{t}-{s}")
             for s in (False, True) for t in (64, 128) for c in (True, False)]
    for c, t, s, d, dt in [(True, 192, False, 64, "float32"),
                           (False, 192, True, 64, "float16"),
                           (True, 128, False, 64, "float16"),
                           (True, 192, True, 128, "float32"),
                           (False, 192, False, 128, "float32"),
                           (True, 192, False, 128, "float16"),
                           (False, 128, True, 128, "float16"),
                           (True, 320, True, 128, "float16")]:
        cases.append(pytest.param(c, t, s, d, dt, id=f"{c}-{t}-{s}-d{d}-{dt}"))
    return cases


def _inputs(t, seed, with_segments, d=32, dtype="float32"):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(2, t, 4, d).astype(dtype) for _ in range(3))
    seg = None
    if with_segments:
        # three documents per row and a padded tail (segment 0)
        cuts = np.sort(rng.choice(np.arange(4, t - 8), 2, replace=False))
        seg = np.ones((2, t), np.int32)
        seg[:, cuts[0]:] = 2
        seg[:, cuts[1]:] = 3
        seg[:, t - 5:] = 0
    return q, k, v, seg


def _jax_fwd(q, k, v, seg, causal):
    """o [B, T, H, D] and lse [B, H, T] from the Pallas forward kernel."""
    b, t, h, d = q.shape
    seg_pair = None
    if seg is not None:
        # the operand layouts flash_attention builds for segment_ids
        segf = jnp.repeat(jnp.asarray(seg), h, axis=0)
        seg_pair = (jnp.broadcast_to(segf[:, :, None], (b * h, t, LSE_LANES)),
                    jnp.broadcast_to(segf[:, None, :], (b * h, LSE_LANES, t)))
    o, lse = _fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg_pair,
                  1.0 / np.sqrt(d), causal, 32, 32)
    o = np.asarray(o).reshape(b, h, t, d).transpose(0, 2, 1, 3)
    return o, np.asarray(lse)[..., 0].reshape(b, h, t)


def _exact_attention(q, k, v, seg, causal):
    """o [B, T, H, D] and lse [B, H, T] in f64 numpy: the masks of the
    kernels (causal, same segment; a padded tail is segment 0 and sees its
    own positions), exact sums."""
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    t = q.shape[1]
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    keep = np.ones((1, 1, t, t), bool)
    if causal:
        keep = keep & np.tril(np.ones((t, t), bool))
    if seg is not None:
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    s = np.where(keep, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    lse = (m + np.log(p.sum(-1, keepdims=True)))[..., 0]
    o = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    return o, lse


@pytest.mark.parametrize("causal,t,with_segments,d,dtype", _cases())
def test_reference_matches_pallas_forward(causal, t, with_segments, d, dtype,
                                          tmp_path):
    """The two sides against each other, and in f32 each side against the
    exact (f64) attention to the same bound, so that a failure names the
    side that moved; the arrays are kept under ``tmp_path`` on a failure."""
    q, k, v, seg = _inputs(t, seed=t + causal, with_segments=with_segments,
                           d=d, dtype=dtype)
    o_jax, lse_jax = _jax_fwd(q, k, v, seg, causal)
    fa.launches = 0
    o, lse = fa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert o.dtype == getattr(torch, dtype) and lse.dtype == torch.float32
    o_tol, lse_tol, _ = TOL[dtype]
    got = {"port": (o.float().numpy(), lse.numpy()),
           "jax": (o_jax.astype(np.float32), lse_jax)}
    checks = [("port", "jax")]
    if dtype == "float32":
        got["exact"] = _exact_attention(q, k, v, seg, causal)
        checks = [("port", "exact"), ("jax", "exact"), ("port", "jax")]
    for a, b in checks:
        for i, (name, tol) in enumerate((("o", o_tol), ("lse", lse_tol))):
            err = np.abs(got[a][i] - got[b][i])
            if err.max() > tol:
                dump = tmp_path / "arrays.npz"
                np.savez(dump, q=q, k=k, v=v, **{
                    f"{side}_{n}": got[side][j] for side in got
                    for j, n in enumerate(("o", "lse"))})
                raise AssertionError(
                    f"{name}: {a} against {b}: {int((err > tol).sum())} of "
                    f"{err.size} elements off by up to {err.max():.3g} "
                    f"(atol {tol}); arrays in {dump}")
    assert fa.launches == 0, "a CPU tensor must not count as a kernel launch"


def test_flash_attention_returns_o_of_fwd():
    q, k, v, _ = (torch.from_numpy(x) if x is not None else None
                  for x in _inputs(64, seed=7, with_segments=False))
    o = fa.flash_attention(q, k, v, causal=True, scale=0.3)
    o_ref, _ = fa.flash_attention_reference(q, k, v, causal=True, scale=0.3)
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)


def test_requires_grad_is_refused():
    """The refusal of inputs that require grad is gone: flash_attention
    records its FlashAttentionFunction node and gradients flow to q, k, v."""
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    o = fa.flash_attention(q, q.detach(), q.detach())
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    o.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape


@pytest.mark.parametrize("causal,t,with_segments,d,dtype", _cases())
def test_gradients_match_jax(causal, t, with_segments, d, dtype):
    """dq, dk, dv of the port's autograd against jax.grad of the JAX
    flash_attention (Pallas backward kernels in interpret mode) for the
    same cotangent."""
    q, k, v, seg = _inputs(t, seed=100 + t + causal, with_segments=with_segments,
                           d=d, dtype=dtype)
    g = np.random.RandomState(t).randn(*q.shape).astype(dtype)

    def jloss(q, k, v):
        o = jax_flash_attention(
            q, k, v, causal=causal, block_q=32, block_k=32,
            segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g, jnp.float32))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    fa.launches = fa.launches_dq = fa.launches_dkv = 0
    o = fa.flash_attention(tq, tk, tv, causal=causal,
                           segment_ids=None if seg is None
                           else torch.from_numpy(seg))
    o.backward(torch.from_numpy(g))
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        ref = np.asarray(ref, np.float32)
        assert got.dtype == getattr(torch, dtype)
        # f32: absolute; fp16: relative to the largest entry (module note)
        atol = ATOL if dtype == "float32" else TOL[dtype][2] * np.abs(ref).max()
        np.testing.assert_allclose(got.float().numpy(), ref, atol=atol,
                                   rtol=0, err_msg=f"d{name}")
    assert (fa.launches, fa.launches_dq, fa.launches_dkv) == (0, 0, 0), \
        "a CPU tensor must not count as a kernel launch"


@pytest.mark.parametrize("causal,with_segments", [(True, False), (True, True),
                                                  (False, True)])
def test_backward_reference_matches_autograd(causal, with_segments):
    """flash_attention_backward_reference (P recomputed from lse) against
    autograd through flash_attention_reference, both in f32: only the order
    of the sums differs (atol 1e-5)."""
    q, k, v, seg = (None if x is None else torch.from_numpy(x)
                    for x in _inputs(64, seed=5, with_segments=with_segments))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal,
                                          segment_ids=seg)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = fa.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do,
        causal=causal, segment_ids=seg)
    for a, b, name in zip(got, want, "qkv"):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL, msg=f"d{name}")


def test_other_segments_leave_gradients_alone():
    """Perturbing another segment's k and v leaves a row's dq unchanged
    (the backward's segment mask), and a fully masked pad row gets finite
    zeros where nothing reaches it."""
    q, k, v, seg = (torch.from_numpy(x) for x in _inputs(64, seed=9,
                                                         with_segments=True))
    do = torch.ones_like(q)

    def dq_of(k, v):
        tq = q.clone().requires_grad_()
        o = fa.flash_attention(tq, k, v, causal=True,
                               segment_ids=torch.from_numpy(seg.numpy()))
        o.backward(do)
        return tq.grad

    base = dq_of(k, v)
    hit = (seg == 2)[:, :, None, None]
    moved = dq_of(k + 3.0 * hit, v - 2.0 * hit)
    keep = ~hit[:, :, 0, 0]
    assert torch.equal(moved[keep], base[keep])
    assert bool(torch.isfinite(base).all())


@pytest.mark.parametrize("bad", ["head_dim", "shape", "dtype", "segments"])
def test_unsupported_inputs_raise(bad):
    q = torch.zeros(1, 8, 2, 32)
    k = v = q
    seg = None
    if bad == "head_dim":
        q = k = v = torch.zeros(1, 8, 2, 24)
    elif bad == "shape":
        k = torch.zeros(1, 9, 2, 32)
    elif bad == "dtype":
        k = q.double()
    else:
        seg = torch.zeros(1, 9, dtype=torch.int32)
    with pytest.raises(ValueError):
        fa.flash_attention_fwd(q, k, v, segment_ids=seg)
