"""The port's rotary embedding against the JAX package's, on the same inputs.

Both sides compute the angles in f32 and cast cos and sin to x's dtype
before the products, in the same order. In f32 they differ only in the last
bits of pow, cos and sin (atol 2e-6 on values of order 1); in bf16 every
product rounds at the same points, and the outputs are bit-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import rotary as jrot
from deepspeed_tpu_torch.ops import rotary as trot

F32_ATOL = 2e-6
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("explicit_positions", [True, False])
@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("pct", [1.0, 0.5])
@pytest.mark.parametrize("interleaved", [False, True])
def test_apply_rotary_matches_jax(interleaved, pct, theta, explicit_positions,
                                  dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(0)
    b, t, h, d = 2, 64, 4, 64
    x = rng.randn(b, t, h, d).astype(np.float32)
    # packed documents' positions restart; positions reach Mistral's 4096
    pos = rng.randint(0, 4096, size=(b, t)) if explicit_positions else None
    rd = int(d * pct)
    want = jrot.apply_rotary_pos_emb(
        jnp.asarray(x, jdt), None if pos is None else jnp.asarray(pos),
        base=theta, rotary_dim=rd, interleaved=interleaved)
    got = trot.apply_rotary_pos_emb(
        torch.tensor(x).to(tdt), None if pos is None else torch.tensor(pos),
        base=theta, rotary_dim=rd, interleaved=interleaved)
    assert got.dtype == tdt and tuple(got.shape) == (b, t, h, d)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "bf16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    # the tail past rotary_dim passes through untouched
    np.testing.assert_array_equal(got[..., rd:],
                                  torch.tensor(x).to(tdt).float()[..., rd:])


@pytest.mark.parametrize("dim,theta", [(64, 1e4), (128, 1e6)])
def test_rotary_angles_match_jax(dim, theta):
    pos = np.arange(4096)[None, :]
    want = jrot.rotary_angles(jnp.asarray(pos), dim, theta)
    got = trot.rotary_angles(torch.tensor(pos), dim, theta)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (1, 4096, dim // 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_ATOL,
                                   rtol=0)
