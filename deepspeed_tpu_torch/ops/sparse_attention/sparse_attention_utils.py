"""Config-to-model wiring for block-sparse attention (counterpart of
``deepspeed_tpu/ops/sparse_attention/sparse_attention_utils.py``:
``get_sparse_attention_config`` :53, ``apply_sparse_attention`` :93,
``pad_to_block_size`` :124, ``unpad_sequence_output`` :143 and the ring KV
cache helpers ``ring_decode_params``, ``ring_engaged``, ``ring_storage_len``,
``RING_DECLINES`` and ``_decline_demanded_ring`` :151-255).

As in the JAX package, the model's *config* carries an optional
``sparse_attention`` field (a :class:`SparsityConfig`) and the attention
module routes on it; :func:`apply_sparse_attention` returns the model
rebuilt with that field populated, and ``deepspeed_tpu_torch.initialize``
calls it when the DeepSpeed config has a ``sparse_attention`` block. The
ring helpers decide whether a GPT decodes from the layout-aware ring cache
(``models/transformer_lm.py`` ``RingKVCache``). A declined demand for the
ring warns and is recorded in ``RING_DECLINES``; the JAX helper also
publishes it on its telemetry bus, which the port does not have until
ROADMAP A.11.
"""

import dataclasses
import inspect
import warnings

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
    ``n_head``) count: ``BertForPreTraining`` and ``GPT`` here. The port's
    models hold their parameters on the meta device until an engine
    materializes them, so the rebuilt model is a new ``type(model)(config)``:
    weights are supplied to the engine separately.
    """
    cfg = getattr(model, "config", None)
    if cfg is None or not dataclasses.is_dataclass(cfg) or not any(
            f.name == "sparse_attention" for f in dataclasses.fields(cfg)):
        raise NotImplementedError(
            f"{type(model).__name__} does not support sparse attention "
            f"injection (its config has no 'sparse_attention' field); "
            f"supported: BertForPreTraining and GPT")
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


def ring_decode_params(sparsity_config):
    """``(past_window_blocks, global_tokens, block)`` when the layout's
    decode-time visibility is "a sliding window of whole blocks plus a
    contiguous run of leading global blocks", the shape a ring KV cache can
    serve exactly, else None.

    Expressible: :class:`LocalSlidingWindowSparsityConfig` (a causal window)
    and a causal :class:`BSLongformerSparsityConfig` whose global blocks
    are a leading contiguous run. BigBird's per-row random links reach
    arbitrary past blocks, which a bounded ring cannot keep; the fixed and
    variable patterns' row-block structure exceeds window + globals too.
    """
    sc = sparsity_config
    if isinstance(sc, LocalSlidingWindowSparsityConfig):
        if sc.attention != "unidirectional":
            return None
        return sc.num_sliding_window_blocks // 2, 0, sc.block
    if isinstance(sc, BSLongformerSparsityConfig):
        if sc.attention != "unidirectional":
            return None
        idx = list(sc.global_block_indices)
        if sc.global_block_end_indices is None:
            spans = [(g, g + 1) for g in idx]
        else:
            spans = list(zip(idx, sc.global_block_end_indices))
        blocks = sorted({b for s, e in spans for b in range(s, e)})
        if blocks != list(range(len(blocks))):
            return None  # globals not a leading contiguous run
        return (sc.num_sliding_window_blocks // 2, len(blocks) * sc.block,
                sc.block)
    return None


def ring_engaged(model_cfg):
    """The one decision the model's decode cache and the inference engine's
    dense-decode warning both consult: the ring parameters when this model
    config decodes through the ring KV cache, else None (the dense cache).

    ``sparse_kv_cache="auto"`` takes the ring only when it is smaller than
    the dense cache and declines silently otherwise; ``True`` demands it
    whatever its size, and a layout with no ring expression then warns and
    is recorded (``_decline_demanded_ring``); ``False`` never rings."""
    sc = getattr(model_cfg, "sparse_attention", None)
    if sc is None:
        return None
    if getattr(model_cfg, "sparse_kv_cache", False) not in ("auto", True):
        return None
    demanded = getattr(model_cfg, "sparse_kv_cache", False) is True
    ring = ring_decode_params(sc)
    if ring is None:
        if demanded:
            _decline_demanded_ring(
                f"layout {type(sc).__name__} has no ring expression")
        return None
    w_blk, g_tok, blk = ring
    if not demanded and g_tok + (w_blk + 1) * blk >= model_cfg.n_positions:
        return None
    return ring


def ring_storage_len(model_cfg, ring) -> int:
    """The ring's capacity in tokens: the ``w_blk + 1`` blocks decode
    visibility needs, plus ``kv_cache_slack_blocks`` blocks of storage.

    Slack changes no result (visibility is by an entry's position, so more
    blocks only delay overwriting) but makes an unaligned multi-token pass
    exact: with one slack block a pass of at most ``block`` tokens never
    evicts an entry one of its own queries still needs (a speculative
    decode's verify pass). Chunked prefill splits at block boundaries and
    needs none. The model's cache and the engine's spans both size the ring
    here."""
    w_blk, g_tok, blk = ring
    slack = int(getattr(model_cfg, "kv_cache_slack_blocks", 0) or 0)
    return (w_blk + 1 + slack) * blk


# the reasons, newest last, for which an explicit sparse_kv_cache=True was
# declined ("auto" declines are silent)
RING_DECLINES: list = []


def _decline_demanded_ring(reason: str) -> None:
    """``sparse_kv_cache=True`` is a demand: record and warn rather than
    decode densely in silence (dense decode sees more keys than the sparse
    training did)."""
    RING_DECLINES.append(reason)
    warnings.warn(
        "sparse_kv_cache=True but the ring KV cache is NOT engaged; decode "
        f"falls back to DENSE attention: {reason}", RuntimeWarning,
        stacklevel=3)
