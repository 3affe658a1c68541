"""The port's flash-attention forward against the JAX package's.

``deepspeed_tpu_torch.ops.cuda.flash_attention`` on CPU tensors runs its plain
PyTorch version; the JAX side runs the Pallas kernel in interpret mode, as
``tests/unit/test_ops.py`` does. Both see the same numpy inputs in f32, so
only the order of the sums differs (atol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.common import LSE_LANES
from deepspeed_tpu.ops.pallas.flash_attention import _fwd
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa

torch.set_num_threads(2)

ATOL = 1e-5


def _inputs(t, seed, with_segments):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(2, t, 4, 32).astype(np.float32) for _ in range(3))
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


@pytest.mark.parametrize("with_segments", [False, True])
@pytest.mark.parametrize("t", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_reference_matches_pallas_forward(causal, t, with_segments):
    q, k, v, seg = _inputs(t, seed=t + causal, with_segments=with_segments)
    o_jax, lse_jax = _jax_fwd(q, k, v, seg, causal)
    fa.launches = 0
    o, lse = fa.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal,
        segment_ids=None if seg is None else torch.from_numpy(seg))
    np.testing.assert_allclose(o.numpy(), o_jax, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), lse_jax, atol=ATOL, rtol=0)
    assert fa.launches == 0, "a CPU tensor must not count as a kernel launch"


def test_flash_attention_returns_o_of_fwd():
    q, k, v, _ = (torch.from_numpy(x) if x is not None else None
                  for x in _inputs(64, seed=7, with_segments=False))
    o = fa.flash_attention(q, k, v, causal=True, scale=0.3)
    o_ref, _ = fa.flash_attention_reference(q, k, v, causal=True, scale=0.3)
    torch.testing.assert_close(o, o_ref, rtol=0, atol=0)


def test_requires_grad_is_refused():
    q = torch.zeros(1, 8, 2, 32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        fa.flash_attention(q, q.detach(), q.detach())


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
