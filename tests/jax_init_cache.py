"""A cache of the JAX package's parameter initialisations for the port's
parity tests (``tests/test_torch_*.py``).

Many parametrised cases build the same flax model from the same seed and
differ only in a field that creates no parameter and draws no initialiser
(the attention route and a block-sparse layout, the compute dtype,
recomputation, dropout): flax's
``init`` runs the whole model eagerly on a dummy input each time, which is
most of such a file's CPU time. ``cached_init`` returns what
``module.init(PRNGKey(seed), x, **kwargs)`` returns, computed once per
process for each (module class, config with those fields set to their
defaults, seed, input shape and dtype, keyword arguments). Those fields are
left out of the key because the tests use the same weights on both sides
of each comparison: a cached tree of the right shapes is a tree the
uncached ``init`` could have drawn. The arrays are JAX's (immutable);
callers that need host copies take them with ``jax.device_get`` (whose
numpy arrays the port's bridge copies again, ``jax_params._tensor``).
"""

import dataclasses

# config fields that add no parameter and change no initialiser's draw
NEUTRAL = {"use_flash_attention": False, "sparse_attention": None,
           "remat": False,
           "remat_policy": "full", "attention_chunk": None, "dropout": 0.0,
           "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0,
           "stochastic_mode": False}

_CACHE = {}


def _key_config(module):
    import jax.numpy as jnp

    cfg = getattr(module, "config", None)
    if cfg is None or not dataclasses.is_dataclass(cfg):
        return repr(module)
    fields = {f.name for f in dataclasses.fields(cfg)}
    neutral = {k: v for k, v in NEUTRAL.items() if k in fields}
    if "dtype" in fields:
        neutral["dtype"] = jnp.float32
    return repr(dataclasses.replace(cfg, **neutral))


def cached_init(module, seed, x, **kwargs):
    """``module.init(jax.random.PRNGKey(seed), x, **kwargs)``, once per
    key (see the module docstring)."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(x)
    key = (type(module).__module__, type(module).__name__,
           _key_config(module), int(seed), tuple(x.shape), str(x.dtype),
           tuple(sorted((k, repr(v)) for k, v in kwargs.items())))
    if key not in _CACHE:
        _CACHE[key] = module.init(jax.random.PRNGKey(seed), x, **kwargs)
    return _CACHE[key]
