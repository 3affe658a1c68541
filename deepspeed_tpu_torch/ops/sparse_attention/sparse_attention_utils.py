"""Config-to-model wiring for block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``:
``get_sparse_attention_config`` :53, ``apply_sparse_attention`` :93,
``pad_to_block_size`` :124 and ``unpad_sequence_output`` :143).

As in the JAX package, the model's *config* carries an optional
``sparse_attention`` field (a :class:`SparsityConfig`) and the attention
module routes on it; :func:`apply_sparse_attention` returns the model
rebuilt with that field populated, and ``deepspeed_tpu_torch.initialize``
calls it when the DeepSpeed config has a ``sparse_attention`` block. The
ring KV cache helpers of the JAX module belong to GPT decoding and are not
ported yet.
"""

import dataclasses
import inspect

import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.ops.sparse_attention.sparsity_config import (
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    LocalSlidingWindowSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)

# the "mode" values of a sparse_attention block
SPARSE_MODE_KEY = "mode"
SPARSE_DENSE_MODE = "dense"
SPARSE_FIXED_MODE = "fixed"
SPARSE_VARIABLE_MODE = "variable"
SPARSE_BIGBIRD_MODE = "bigbird"
SPARSE_BSLONGFORMER_MODE = "bslongformer"
SPARSE_LOCAL_SLIDING_WINDOW_MODE = "local_sliding_window"

_MODE_TO_CONFIG = {
    SPARSE_DENSE_MODE: DenseSparsityConfig,
    SPARSE_FIXED_MODE: FixedSparsityConfig,
    SPARSE_VARIABLE_MODE: VariableSparsityConfig,
    SPARSE_BIGBIRD_MODE: BigBirdSparsityConfig,
    SPARSE_BSLONGFORMER_MODE: BSLongformerSparsityConfig,
    SPARSE_LOCAL_SLIDING_WINDOW_MODE: LocalSlidingWindowSparsityConfig,
}


def get_sparse_attention_config(param_dict: dict,
                                num_heads: int) -> SparsityConfig:
    """Build a :class:`SparsityConfig` from a DeepSpeed ``sparse_attention``
    config block. ``num_heads`` comes from the model, not the JSON."""
    if isinstance(param_dict, SparsityConfig):
        return param_dict
    params = dict(param_dict or {})
    mode = params.pop(SPARSE_MODE_KEY, SPARSE_FIXED_MODE)
    # implementation selector, not a layout parameter: "gather" (default,
    # static K/V-block gathers + batched products), "pallas" (the streaming
    # block-sparse kernels) or "dense" (masked full attention, for testing)
    kernel_impl = params.pop("kernel", None)
    cls = _MODE_TO_CONFIG.get(mode)
    if cls is None:
        raise NotImplementedError(
            f"sparse_attention mode '{mode}' is not supported; choose from "
            f"{sorted(_MODE_TO_CONFIG)}")
    # num_heads comes from the model, never from the JSON: reject it here
    # or cls(num_heads=..., **params) dies with a confusing TypeError
    accepted = set(inspect.signature(cls.__init__).parameters) \
        - {"self", "num_heads"}
    unknown = set(params) - accepted
    if unknown:
        raise ValueError(
            f"sparse_attention ({mode}): unknown keys {sorted(unknown)}; "
            f"accepted: {sorted(accepted)}")
    sc = cls(num_heads=num_heads, **params)
    if kernel_impl is not None:
        if kernel_impl not in ("gather", "pallas", "dense"):
            raise ValueError(
                f"sparse_attention kernel must be 'gather', 'pallas' or "
                f"'dense', got '{kernel_impl}'")
        sc.kernel_impl = kernel_impl
    return sc


def apply_sparse_attention(model, sparse_config):
    """Return ``model`` rebuilt with block-sparse attention enabled.

    ``sparse_config`` is the DeepSpeed ``sparse_attention`` dict (or an
    already-built :class:`SparsityConfig`). The model's config dataclass
    must have a ``sparse_attention`` field and a ``num_attention_heads`` (or
    ``n_head``) count. The port's models hold their parameters on the meta
    device until an engine materializes them, so the rebuilt model is a new
    ``type(model)(config)``: weights are supplied to the engine separately.
    A ``GPT`` refuses the field (its sparse route is not ported yet).
    """
    cfg = getattr(model, "config", None)
    if cfg is None or not dataclasses.is_dataclass(cfg) or not any(
            f.name == "sparse_attention" for f in dataclasses.fields(cfg)):
        raise NotImplementedError(
            f"{type(model).__name__} does not support sparse attention "
            f"injection (its config has no 'sparse_attention' field); "
            f"supported: BertForPreTraining")
    num_heads = getattr(cfg, "num_attention_heads",
                        getattr(cfg, "n_head", None))
    if num_heads is None:
        raise ValueError(
            f"cannot inject sparse attention into {type(model).__name__}: "
            f"its config ({type(cfg).__name__}) exposes neither "
            f"'num_attention_heads' nor 'n_head', so the SparsityConfig "
            f"head count cannot be resolved")
    sc = get_sparse_attention_config(sparse_config, num_heads)
    return type(model)(dataclasses.replace(cfg, sparse_attention=sc))


def pad_to_block_size(block: int, input_ids, attention_mask=None,
                      pad_token_id: int = 0):
    """Pad ``[B, T]`` token inputs on the right so T is a block multiple.
    Returns ``(pad_len, input_ids, attention_mask)``; padded keys are masked
    out."""
    t = input_ids.shape[1]
    pad_len = (-t) % block
    if pad_len == 0:
        return 0, input_ids, attention_mask
    input_ids = F.pad(torch.as_tensor(input_ids), (0, pad_len),
                      value=pad_token_id)
    if attention_mask is None:
        attention_mask = torch.ones((input_ids.shape[0], t), dtype=torch.bool,
                                    device=input_ids.device)
    attention_mask = F.pad(torch.as_tensor(attention_mask).bool(),
                           (0, pad_len), value=False)
    return pad_len, input_ids, attention_mask


def unpad_sequence_output(pad_len: int, sequence_output):
    """Strip padding added by :func:`pad_to_block_size` from ``[B, T, ...]``
    model output."""
    if pad_len == 0:
        return sequence_output
    return sequence_output[:, :-pad_len]
