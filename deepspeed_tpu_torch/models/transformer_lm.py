"""Decoder-only transformer LM of the GPT-2 and LLaMA families (counterpart
of ``deepspeed_tpu/models/transformer_lm.py``).

The same config, the same math and the same parameter names as the flax
model, in PyTorch idiom: ``nn.Module``s, a layer loop over an
``nn.ModuleList`` in place of ``nn.scan``, and the decode KV cache as an
explicit ``KVCache`` passed in and returned in place of flax's mutable
``cache`` collection. Parameters are stored in ``param_dtype`` and every
op computes in ``dtype``, as flax's ``Dense``/``Embed``/``LayerNorm`` do.

The port covers the pre-LN trunk in its shapes: GPT-2's (LayerNorm,
biases, learned positions, a head tied to the embedding), LLaMA's or
Mistral's (``norm="rmsnorm"``, the gated SiLU MLP, bias-free layers, rotary
embeddings, grouped-query attention over ``n_kv_head`` KV heads, an untied
``lm_head``), GPT-NeoX's and GPT-J's (``parallel_residual``: attention and
MLP both read the block's input), BLOOM's (``alibi`` position biases in
place of positions, ``embed_layernorm`` after the embedding) and
Mixtral's (``moe_num_experts`` > 0: the MLP becomes a top-k gated mixture
of experts, ``moe/``), and the mixes between them that the config allows:
the logits path (einsum, flash and chunked attention for full forwards,
routed as JAX routes them, ``"auto"`` included; the block-sparse route of
a ``sparse_attention`` layout, on the kernels B5-B7 or their plain
versions; the dense-cache decode path, and the ring cache of a window
layout)
and the training path (``labels`` -> mean next-token cross entropy, or the
fused head + CE, plus the experts' load-balancing loss; packed
``segment_ids``/``positions``; activation recomputation under JAX's four
``remat_policy`` values; dropout at JAX's sites and stochastic depth, both
drawn from a generator the caller passes). Config fields of features not
ported yet raise ``NotImplementedError`` when set away from their
defaults.
"""

import dataclasses
import functools
import math
from typing import Any, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# field -> (default, feature, ROADMAP item) for GPTConfig fields whose
# feature this port does not have yet
_UNPORTED = {
    "flash_autotune": (False, "the flash block autotuner", "A.12"),
    "param_offload": (False, "parameter offload", "A.10"),
    "sequence_parallel": ("none", "sequence parallelism", "A.9"),
    "quantized_weights": (False, "int8 weights", "A.8"),
    "kv_cache_dtype": (None, "the int8 KV cache", "A.8"),
}


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """The fields and defaults of ``deepspeed_tpu``'s ``GPTConfig``, with
    torch dtypes. ``dropout`` and ``stochastic_mode`` act in training mode
    only (serving runs in eval mode, as the JAX engine serves with
    ``deterministic=True``)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    mlp_ratio: int = 4
    layer_norm_epsilon: float = 1e-5
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    intermediate_size: Optional[int] = None
    norm: str = "layernorm"
    activation: str = "gelu_tanh"
    causal: bool = True
    gated_mlp: bool = False
    use_bias: bool = True
    attn_bias: Optional[bool] = None
    alibi: bool = False
    embed_layernorm: bool = False
    rotary: bool = False
    rotary_pct: float = 1.0
    rotary_interleaved: bool = False
    rope_theta: float = 10000.0
    learned_positions: bool = True
    tie_word_embeddings: bool = True
    lm_head_bias: bool = False
    parallel_residual: bool = False
    n_kv_head: Optional[int] = None
    remat: bool = False
    remat_policy: str = "full"
    # the layout of the JAX parameter tree this config pairs with (one
    # stacked "h/block" or "h_0".."h_{n-1}"); the port always loops
    scan_layers: bool = True
    # True routes full forwards (no mask, T % 128 == 0, no training
    # dropout) through the flash kernel; "auto" picks einsum, flash or
    # chunked by T at the crossovers measured on the card (FLASH_AUTO_MIN_SEQ,
    # FLASH_MAX_SEQ)
    use_flash_attention: Any = False
    flash_autotune: bool = False
    attention_chunk: Optional[int] = None
    param_offload: bool = False
    sequence_parallel: str = "none"
    fused_head_ce: Any = "auto"
    sparse_attention: Any = None
    sparse_kv_cache: Any = "auto"
    quantized_weights: bool = False
    kv_cache_dtype: Any = None
    kv_cache_slack_blocks: int = 0
    stochastic_mode: bool = False
    moe_num_experts: int = 0
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.0
    moe_eval_capacity_factor: float = 1.0
    moe_min_capacity: int = 4
    moe_drop_tokens: bool = True
    moe_aux_loss_coef: float = 0.01
    moe_noisy_gate_policy: Optional[str] = None
    moe_use_rts: bool = True
    moe_gated_experts: bool = False

    def __post_init__(self):
        # the JAX config's own refusals (transformer_lm.py:195-231)
        if self.sparse_attention is not None and self.alibi:
            raise ValueError(
                "sparse_attention does not compose with alibi (the "
                "block-sparse path has no positional-bias hook); a silent "
                "dense fallback would change the model's math, so this is "
                "rejected up front")
        for name, (default, feature, item) in _UNPORTED.items():
            value = getattr(self, name)
            if value is not default and value != default:
                raise NotImplementedError(
                    f"GPTConfig.{name}={value!r}: {feature} is not ported to "
                    f"deepspeed_tpu_torch yet (ROADMAP {item})")
        if self.use_flash_attention not in (True, False, "auto"):
            raise ValueError(
                f"use_flash_attention must be True, False or 'auto'; got "
                f"{self.use_flash_attention!r}")
        if self.attention_chunk is not None and (
                not isinstance(self.attention_chunk, int)
                or self.attention_chunk <= 0):
            raise ValueError(
                f"attention_chunk must be a positive int or None; got "
                f"{self.attention_chunk!r}")
        if not isinstance(self.kv_cache_slack_blocks, int) or \
                self.kv_cache_slack_blocks < 0:
            raise ValueError(
                f"kv_cache_slack_blocks must be a non-negative int; got "
                f"{self.kv_cache_slack_blocks!r}")
        if self.sparse_kv_cache not in ("auto", True, False):
            raise ValueError(
                f"sparse_kv_cache must be 'auto', True or False; got "
                f"{self.sparse_kv_cache!r}")
        if self.sparse_kv_cache is True:
            from deepspeed_tpu_torch.ops.sparse_attention.\
                sparse_attention_utils import ring_decode_params

            if (self.sparse_attention is None
                    or ring_decode_params(self.sparse_attention) is None):
                raise ValueError(
                    "sparse_kv_cache=True needs a ring-expressible layout "
                    "(causal sliding-window, or longformer with leading "
                    "global blocks); BigBird's random links cannot be "
                    "served from a bounded ring — use 'auto' to fall back "
                    "to the dense cache")
        _remat_policy(self.remat_policy)  # raises for an unknown name
        # bool first: True is an int. "auto" decides per call; True or an
        # int >= 1 (the token chunk) forces the fused head, False or 0 not
        fused = self.fused_head_ce
        if not (fused == "auto" or isinstance(fused, bool) or (
                isinstance(fused, int) and fused >= 0)):
            raise ValueError(f"unknown fused_head_ce {fused!r}")
        if self.norm not in ("layernorm", "rmsnorm"):
            raise ValueError(f"unknown norm {self.norm!r}")
        if self.activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {self.activation!r}")
        if self.n_kv_head is not None and self.n_head % self.n_kv_head:
            raise ValueError(
                f"n_head ({self.n_head}) must be divisible by n_kv_head "
                f"({self.n_kv_head})")
        if self.n_embd % self.n_head:
            raise ValueError(
                f"n_embd ({self.n_embd}) must be divisible by n_head "
                f"({self.n_head})")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def ffn_dim(self) -> int:
        return self.intermediate_size or self.mlp_ratio * self.n_embd

    @property
    def rotary_dim(self) -> int:
        rd = round(self.rotary_pct * self.head_dim)
        return rd - rd % 2

    @property
    def is_moe(self) -> bool:
        return self.moe_num_experts > 0


GPT2_SIZES = {
    "gpt2-125m": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-350m": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-760m": dict(n_embd=1536, n_layer=24, n_head=16),
    "gpt2-1.3b": dict(n_embd=2048, n_layer=24, n_head=16),
    "gpt2-2.7b": dict(n_embd=2560, n_layer=32, n_head=32),
    "gpt2-6.7b": dict(n_embd=4096, n_layer=32, n_head=32),
}


def gpt2_config(name: str, **overrides) -> GPTConfig:
    base = dict(GPT2_SIZES[name])
    base.update(overrides)
    return GPTConfig(**base)


# fused_head_ce="auto" engages the fused head once the [B, T, V] logits
# would take this many bytes (transformer_lm.py:1196-1198); True means
# chunks of this many tokens
FUSED_HEAD_CE_AUTO_BYTES = 4 << 30
FUSED_HEAD_CE_CHUNK = 2048

# use_flash_attention="auto" (JAX :694-725, the card's constants): einsum
# attention below FLASH_AUTO_MIN_SEQ, the flash kernels from there up to
# FLASH_MAX_SEQ, the chunked path past it at the largest of
# (CHUNKED_AUTO_CHUNK, 512, 256, 128) dividing T. chip_smoke.py's sweep
# (flash_auto_sweep: causal bf16, D 64 and 128, T 128-8192) on an NVIDIA
# H100 80GB HBM3 at 700.00 W: the flash kernels beat the einsum path at
# every T measured, forward (8-54x) and forward + backward (2.2-24x), so
# flash from the shortest T its gate takes (128) to the longest measured
FLASH_AUTO_MIN_SEQ = 128
FLASH_MAX_SEQ = 8192
CHUNKED_AUTO_CHUNK = 1024

_ACTIVATIONS = {
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "relu": F.relu,
    "silu": F.silu,
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
}


def pld_keep_probability(layer_idx, n_layer: int, theta):
    """Layer ``layer_idx`` survives stochastic depth with ``1 - (i / L)(1 -
    theta)`` (JAX :943): deeper layers drop more. ``layer_idx`` and
    ``theta`` may be numbers or tensors."""
    return 1.0 - (layer_idx / n_layer) * (1.0 - theta)


def _remat_policy(name: str):
    """The recomputation policy of ``remat_policy`` (JAX ``_remat_policy``,
    :954-985), as ``runtime/activation_checkpointing`` policies:
    ``selective`` keeps the parameter products and the flash forward's o
    and lse (B1 then runs once per layer), ``save_dots`` every product,
    batched ones included (B1 runs again: a kernel is not a dot),
    ``save_nothing_but_flash`` only B1's o and lse (``full`` on the einsum
    path, where nothing carries those names), ``full`` nothing. On the
    block-sparse route no policy keeps B5's output (its autograd function
    launches through ctypes, which no policy sees): B5 runs again in every
    recompute, as the Pallas kernel does under JAX's policies, and
    ``selective``/``save_dots`` keep the products around it."""
    from deepspeed_tpu_torch.runtime.activation_checkpointing import \
        checkpointing as ac

    if name == "selective":
        return ac.save_from_both_policies(
            ac.dots_with_no_batch_dims_saveable,
            ac.save_only_these_names("attn_out", "attn_lse"))
    if name == "save_dots":
        return ac.dots_saveable
    if name == "save_nothing_but_flash":
        return ac.save_only_these_names("attn_out", "attn_lse")
    if name == "full":
        return ac.nothing_saveable
    raise ValueError(f"unknown remat_policy {name!r}")


def attention_route(cfg: "GPTConfig", t: int, *, mask=False, segments=False,
                    training_dropout=False):
    """Which path a full forward of length ``t`` takes (JAX :689-725):
    ``("chunked", chunk)``, ``("flash", None)`` or ``("einsum", None)``.
    ``mask``/``segments``: a padding mask or packed segment ids is present;
    ``training_dropout``: dropout > 0 in training, which keeps attention on
    the einsum path (the flash and chunked paths have no probability
    dropout). An explicit ``attention_chunk`` wins over flash; ``"auto"``
    chunks past ``FLASH_MAX_SEQ`` and picks flash from
    ``FLASH_AUTO_MIN_SEQ``."""
    auto = cfg.use_flash_attention == "auto"
    auto_chunk = None
    if auto and t > FLASH_MAX_SEQ:
        auto_chunk = next((c for c in (CHUNKED_AUTO_CHUNK, 512, 256, 128)
                           if t % c == 0), None)
    chunk = cfg.attention_chunk or auto_chunk
    plain = not mask and not cfg.alibi and not training_dropout
    if (chunk and plain and not segments and t % chunk == 0
            and t > chunk):
        return "chunked", chunk
    want_flash = (FLASH_AUTO_MIN_SEQ <= t <= FLASH_MAX_SEQ if auto
                  else cfg.use_flash_attention)
    if want_flash and plain and t % 128 == 0:
        return "flash", None
    return "einsum", None


def fused_head_engages(cfg: "GPTConfig", batch: int, seq: int):
    """The token chunk of the fused head + CE for a ``[batch, seq]`` call,
    or 0 for the unfused head (JAX :1188-1213): ``"auto"`` fuses once the
    compute-dtype logits of the call reach ``FUSED_HEAD_CE_AUTO_BYTES``;
    ``True`` means ``FUSED_HEAD_CE_CHUNK``; an int is the chunk (bool is
    tested first: True is an int)."""
    fused = cfg.fused_head_ce
    if fused == "auto":
        itemsize = torch.finfo(cfg.dtype).bits // 8
        fused = (batch * seq * cfg.vocab_size * itemsize
                 >= FUSED_HEAD_CE_AUTO_BYTES)
    if isinstance(fused, bool):
        return FUSED_HEAD_CE_CHUNK if fused else 0
    return fused


def alibi_slopes(n_head: int) -> np.ndarray:
    """Per-head ALiBi slopes (JAX :856-869; HF ``build_alibi_tensor``'s
    math), f32, exact for head counts that are not powers of two."""
    closest = 2 ** math.floor(math.log2(n_head))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** i for i in range(1, closest + 1)]
    if closest != n_head:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        n_extra = min(closest, n_head - closest)
        slopes += [extra_base ** i for i in range(1, 2 * n_extra, 2)]
    return np.asarray(slopes, np.float32)


@functools.lru_cache(maxsize=None)
def _alibi_slopes_on(n_head: int, device: torch.device) -> torch.Tensor:
    """``alibi_slopes`` as an f32 tensor on ``device``, made once: a
    captured step reads it and never copies host values itself (its first,
    uncaptured call makes it)."""
    return torch.from_numpy(alibi_slopes(n_head)).to(device)


def alibi_bias(n_head: int, length: int, dtype, device) -> torch.Tensor:
    """``[n_head, length]`` f32: each head's slope times the key positions
    ``0 .. length - 1`` taken in ``dtype``, the scores' dtype, as JAX
    builds them (``jnp.arange(T, dtype=att.dtype)``; the scores are f32 in
    both packages, so the positions are exact: bf16 would round them past
    256); the f32 slopes make the product f32."""
    pos = torch.arange(length, device=device).to(dtype)
    return _alibi_slopes_on(n_head, device)[:, None] * pos[None, :]


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode, inverted dropout at ``rate``,
    ``where(mask, x / keep, 0)`` with a keep mask drawn from the generator
    given at the call (``bernoulli_mask``: the remat recompute gets the
    forward's mask back); in eval mode, or at rate 0, ``x`` itself. No
    parameters."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator]):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            # flax's edge case: no NaN gradient from x / 0
            return torch.zeros_like(x)
        from deepspeed_tpu_torch.runtime.activation_checkpointing import \
            bernoulli_mask

        keep = 1.0 - self.rate
        mask = bernoulli_mask(x.shape, keep, generator, x.device)
        return torch.where(mask, x / keep, 0.0)


class Dense(nn.Linear):
    """flax ``nn.Dense``: weight and bias cast to the compute dtype at use.
    The weight is torch's ``[out, in]``; the JAX kernel is its transpose.
    ``bias=False`` is ``use_bias=False``: no bias parameter."""

    def __init__(self, in_features, out_features, cfg, bias=True):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` (the ``_norm`` layernorm branch): statistics and
    the affine map in f32, the result cast to the compute dtype. ``width``
    features, ``eps`` as the model's config names it; ``bias=False`` is
    ``use_bias=False``."""

    def __init__(self, width, eps, cfg, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width, dtype=cfg.param_dtype))
        self.bias = (nn.Parameter(torch.zeros(width, dtype=cfg.param_dtype))
                     if bias else None)
        self.eps = eps
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.float()
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         bias, self.eps)
        return y.to(self.compute_dtype)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm`` (the ``_norm`` rmsnorm branch): the mean of squares
    in f32, ``rsqrt(var + eps)`` times the scale (``weight``, flax's
    ``scale``, one per feature), times x in f32, cast to the compute dtype
    (flax ``_compute_stats`` with ``use_mean=False``, then ``_normalize``)."""

    def __init__(self, width, eps, cfg):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width, dtype=cfg.param_dtype))
        self.eps = eps
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return (xf * mul).to(self.compute_dtype)


def _norm(cfg: "GPTConfig"):
    """The config's norm over ``n_embd`` features (JAX ``_norm``)."""
    if cfg.norm == "rmsnorm":
        return RMSNorm(cfg.n_embd, cfg.layer_norm_epsilon, cfg)
    return LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon, cfg,
                     bias=cfg.use_bias)


class VocabEmbed(nn.Embedding):
    """flax ``nn.Embed`` gather (``VocabEmbed``'s tp == 1 branch): the table
    is cast to the compute dtype, then rows are taken."""

    def __init__(self, num, features, cfg):
        super().__init__(num, features, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, ids):
        return F.embedding(ids, self.weight.to(self.compute_dtype))


@dataclasses.dataclass
class KVCache:
    """The dense decode cache (flax's ``cache`` collection,
    ``transformer_lm.py:565-612``, plus the position counter at :1114).

    ``key``/``value`` hold one ``[B, n_positions, Hkv, D]`` buffer per layer:
    the KV heads, not repeated to the query heads (grouped-query attention
    reads each one for its group of queries). Keys are stored rotated when
    the model is rotary. ``valid`` ([B, n_positions]) marks written real
    tokens, ``index`` ([B]) is each row's next write slot and ``position``
    ([B]) each row's next learned position (None for a model without a
    position table). The flax model keeps a copy of ``valid`` and ``index``
    in every layer; all copies are equal, so one serves here. The buffers
    are updated in place.

    Every call appends its T columns to every row, so ``length``, a host
    int, bounds all rows' ``index``: a call that would write past the cache
    raises, where flax's ``mode="drop"`` writes would silently drop tokens.
    Knowing that on the host keeps the writes free of device syncs.
    """

    key: List[torch.Tensor]
    value: List[torch.Tensor]
    valid: torch.Tensor
    index: torch.Tensor
    position: Optional[torch.Tensor]
    length: int = 0

    @classmethod
    def empty(cls, cfg: GPTConfig, batch: int, device, slots=None,
              **fields) -> "KVCache":
        """Zeroed buffers of ``slots`` cache slots (default
        ``n_positions``)."""
        slots = cfg.n_positions if slots is None else slots
        shape = (batch, slots, cfg.kv_heads, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=cfg.dtype, device=device)

        return cls(
            key=[zeros() for _ in range(cfg.n_layer)],
            value=[zeros() for _ in range(cfg.n_layer)],
            valid=torch.zeros((batch, slots), dtype=torch.bool,
                              device=device),
            index=torch.zeros(batch, dtype=torch.long, device=device),
            position=(torch.zeros(batch, dtype=torch.long, device=device)
                      if cfg.learned_positions else None), **fields)

    def reset(self) -> "KVCache":
        """Empty again, in place: the buffers keep their addresses (a
        captured decode step reads and writes them) and hold what
        ``empty`` makes."""
        for buf in (*self.key, *self.value, self.valid, self.index,
                    self.position):
            if buf is not None:
                buf.zero_()
        self.length = 0
        return self

    def step(self, cfg: GPTConfig, written: torch.Tensor) -> "_DecodeStep":
        """The next call's slots ([B, T]: each row's next T), its validity
        written (``written`` [B, T] bool: the real tokens) and the slots
        each query may not see: later ones and those holding no real token
        (JAX :589-633)."""
        B, T = written.shape
        if self.length + T > cfg.n_positions:
            raise ValueError(
                f"{T} more tokens overflow the KV cache ({self.length} "
                f"of n_positions={cfg.n_positions} written)")
        dev = written.device
        slots = self.index[:, None] + torch.arange(T, device=dev)
        rows = torch.arange(B, device=dev)[:, None]
        self.valid[rows, slots] = written
        k_pos = torch.arange(self.valid.shape[1], device=dev)
        visible = (k_pos[None, None, :] <= slots[:, :, None]) \
            & self.valid[:, None, :]                            # [B,T,S]
        return _DecodeStep(self, rows, slots, (slots,),
                           ~visible[:, None, None])


@dataclasses.dataclass
class RingKVCache(KVCache):
    """The layout-aware ring decode cache (the JAX attention's ring branch,
    ``transformer_lm.py:440-537``) of a window (+ leading globals) sparse
    layout: only the slots the layout can still attend, so decode computes
    the training block-sparse attention exactly.

    ``ring`` is ``(w_blk, g_tok, blk)`` (``ring_engaged``) and ``ring_len``
    the ring's storage (``ring_storage_len``): each buffer holds ``g_tok +
    ring_len`` slots, the first ``g_tok`` for the leading global tokens.
    Position p is written to slot ``g_tok + p % ring_len``, and a global
    token also to slot p. ``slot_pos`` ([B, S], -1 = empty) holds each
    slot's position, from which visibility is computed on the device:
    ``0 <= slot_pos <= q_pos`` and either a global slot or a ring slot whose
    block lies within ``w_blk`` blocks of the query's. A pass of more than
    ``ring_len`` tokens would evict keys its own queries need, and raises.
    Without a position table (rotary) nothing caps the stream; with one,
    ``n_positions`` does, as for the dense cache."""

    slot_pos: Optional[torch.Tensor] = None
    ring: tuple = (0, 0, 1)
    ring_len: int = 0

    @classmethod
    def empty(cls, cfg: GPTConfig, batch: int, device, *,
              ring) -> "RingKVCache":
        from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
            import ring_storage_len

        ring_len = ring_storage_len(cfg, ring)
        slots = ring[1] + ring_len
        return super().empty(
            cfg, batch, device, slots=slots, ring=tuple(ring),
            ring_len=ring_len,
            slot_pos=torch.full((batch, slots), -1, dtype=torch.long,
                                device=device))

    def reset(self) -> "RingKVCache":
        super().reset()
        self.slot_pos.fill_(-1)
        return self

    def step(self, cfg: GPTConfig, written: torch.Tensor) -> "_DecodeStep":
        B, T = written.shape
        w_blk, g_tok, blk = self.ring
        if T > self.ring_len:
            raise ValueError(
                f"ring KV prefill got {T} tokens in one pass but "
                f"the ring retains only {self.ring_len} positions: keys "
                "a mid-prompt query still needs would be evicted "
                "before it attends, and the corrupted attention "
                "outputs would poison every later layer's cache "
                "(and with it every generated token). Prefill long "
                "prompts in block-aligned chunks instead — "
                "InferenceEngine.generate and the continuous-"
                "batching scheduler do this automatically "
                "(inference/engine.py prefill_chunk_spans).")
        if cfg.learned_positions and self.length + T > cfg.n_positions:
            raise ValueError(
                f"{T} more tokens overflow the position table ({self.length} "
                f"of n_positions={cfg.n_positions} written)")
        dev = written.device
        pos = self.index[:, None] + torch.arange(T, device=dev)   # [B, T]
        slots = (g_tok + pos % self.ring_len,)
        if g_tok:
            # a leading-global token also lands in its own slot; the others
            # write their ring slot again (the same values)
            slots += (torch.where(pos < g_tok, pos, slots[0]),)
        rows = torch.arange(B, device=dev)[:, None]
        for slot in slots:
            self.valid[rows, slot] = written
            self.slot_pos[rows, slot] = pos
        S = self.valid.shape[1]
        q_pos = pos[:, :, None]                                  # [B, T, 1]
        ps = self.slot_pos[:, None, :]                           # [B, 1, S]
        is_glob = torch.arange(S, device=dev) < g_tok
        in_window = ps.div(blk, rounding_mode="floor") >= \
            q_pos.div(blk, rounding_mode="floor") - w_blk
        visible = ((ps >= 0) & (ps <= q_pos)
                   & (is_glob | (in_window & (ps >= g_tok)))
                   & self.valid[:, None, :])                     # [B, T, S]
        return _DecodeStep(self, rows, pos, slots, ~visible[:, None, None])


def kv_cache(cfg: GPTConfig, batch: int, device) -> KVCache:
    """An empty decode cache for ``batch`` rows: the ring cache when the
    config's sparse layout engages it (``ring_engaged``), else the dense
    cache."""
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
        import ring_engaged

    ring = ring_engaged(cfg)
    if ring is not None:
        return RingKVCache.empty(cfg, batch, device, ring=ring)
    return KVCache.empty(cfg, batch, device)


@dataclasses.dataclass
class _DecodeStep:
    """What every layer of one decode call shares: the cache, the rotary
    positions ([B, T], JAX :589-594) and the slots this call writes (one or
    more [B, T] sets), and the cache entries each query may not see ([B, 1,
    1, T, S])."""

    cache: KVCache
    rows: torch.Tensor
    positions: torch.Tensor
    slots: tuple
    hidden: torch.Tensor

    def write(self, buf, vals):
        """``buf[b, slots[b, t]] = vals[b, t]`` for each slot set
        (``.at[rows, slots].set``)."""
        vals = vals.to(buf.dtype)
        for slots in self.slots:
            buf[self.rows, slots] = vals


def einsum_attention(q, k, v, *, causal=True, mask=None, segment_ids=None,
                     alibi=False, dropout=None, generator=None):
    """The einsum path (JAX :727-756) over ``[B, T, H, D]`` q, k, v: f32
    scores (JAX's scale is a numpy f64 scalar, which, unlike a Python float,
    promotes the compute-dtype product), the ALiBi bias, the causal, padding
    (``mask`` [B, T]) and segment masks, an f32 softmax cast to q's dtype,
    then ``dropout`` (a ``Dropout``, drawing from ``generator``) on the
    probabilities. Returns ``[B, T, H, D]``."""
    B, T, H, D = q.shape
    att = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)
                       ).float() * (1.0 / math.sqrt(D))         # [B,H,T,T]
    if alibi:
        # slopes[h] * key position (JAX :736-742)
        att = att + alibi_bias(H, T, att.dtype, q.device)[None, :, None, :]
    if causal:
        tri = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        att = att.masked_fill(~tri, torch.finfo(att.dtype).min)
    if mask is not None:
        att = att.masked_fill(~mask.bool()[:, None, None, :],
                              torch.finfo(att.dtype).min)
    if segment_ids is not None:
        # NaN-safe: the causal diagonal is always same-segment
        same = (segment_ids[:, None, :, None]
                == segment_ids[:, None, None, :])
        att = att.masked_fill(~same, torch.finfo(att.dtype).min)
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    if dropout is not None:
        att = dropout(att, generator)
    return torch.matmul(att, v.transpose(1, 2)).transpose(1, 2)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.cfg = cfg
        bias = cfg.use_bias if cfg.attn_bias is None else cfg.attn_bias
        width = (cfg.n_head + 2 * cfg.kv_heads) * cfg.head_dim
        self.c_attn = Dense(cfg.n_embd, width, cfg, bias=bias)
        self.c_proj = Dense(cfg.n_embd, cfg.n_embd, cfg, bias=bias)
        # the probabilities' and the output's dropout (JAX :756, :761)
        self.dropout = Dropout(cfg.dropout)
        # the block-sparse route (JAX :649-667): its layouts, and through
        # them the kernels' index tables, are made once per length
        self.sparse = None
        if cfg.sparse_attention is not None:
            from deepspeed_tpu_torch.ops.sparse_attention import \
                SparseSelfAttention

            self.sparse = SparseSelfAttention(
                cfg.sparse_attention, max_seq_length=cfg.n_positions)

    def _rope(self, t, positions):
        from deepspeed_tpu_torch.ops.rotary import apply_rotary_pos_emb

        cfg = self.cfg
        return apply_rotary_pos_emb(t, positions, base=cfg.rope_theta,
                                    rotary_dim=cfg.rotary_dim,
                                    interleaved=cfg.rotary_interleaved)

    def forward(self, x, mask=None, step=None, layer=0, segment_ids=None,
                positions=None, rng=None):
        """Full forward when ``step`` is None; otherwise the decode path:
        write this call's keys and values into the layer's cache buffers and
        attend over the whole cache. ``segment_ids`` ([B, T], packed
        batches) restricts each query to keys of its own segment;
        ``positions`` ([B, T]) are the rotary positions of a full forward
        (default ``arange(T)``; packed documents restart them); ``rng`` is
        the generator of the dropout masks (training only)."""
        cfg = self.cfg
        B, T, C = x.shape
        H, Hkv, D = cfg.n_head, cfg.kv_heads, cfg.head_dim
        G = H // Hkv
        qkv = self.c_attn(x)
        # views into the fused projection, split q | k | v (JAX :399-404):
        # the flash kernel reads them through their strides
        q, k, v = qkv.split((H * D, Hkv * D, Hkv * D), dim=-1)
        q, k, v = q.view(B, T, H, D), k.view(B, T, Hkv, D), v.view(B, T, Hkv, D)
        scale = 1.0 / math.sqrt(D)

        if step is not None:
            if cfg.rotary:
                # rotated at the token's position, before the write: cached
                # keys hold their phase (JAX :589-594)
                q, k = (self._rope(q, step.positions),
                        self._rope(k, step.positions))
            k_all, v_all = step.cache.key[layer], step.cache.value[layer]
            step.write(k_all, k)
            step.write(v_all, v)
            # grouped attention against the un-repeated cache (JAX
            # :619-633, bqhgd,bkhd->bhgqk): query head h = g_kv * G + g
            qg = q.view(B, T, Hkv, G, D).permute(0, 2, 3, 1, 4)
            att = torch.matmul(qg.reshape(B, Hkv, G * T, D),
                               k_all.permute(0, 2, 3, 1)).float() * scale
            att = att.view(B, Hkv, G, T, -1)                    # [B,h,g,T,S]
            if cfg.alibi:
                # slopes[h] times the absolute cache slot (JAX :624-627)
                att = att + alibi_bias(H, cfg.n_positions, att.dtype,
                                       x.device).view(Hkv, G, 1, -1)
            att = att.masked_fill(step.hidden, torch.finfo(att.dtype).min)
            att = torch.softmax(att.float(), dim=-1)
            # a query that sees nothing gets no weight (JAX's
            # softmax(where=visible) on the ring; on the dense cache such a
            # query is a pad, whose output no valid entry or logit reads)
            att = att.masked_fill(step.hidden, 0.0)
            att = att.to(cfg.dtype)
            y = torch.matmul(att.view(B, Hkv, G * T, -1),
                             v_all.transpose(1, 2))              # [B,h,GT,D]
            y = y.view(B, Hkv, G, T, D).permute(0, 3, 1, 2, 4)
            return self.c_proj(y.reshape(B, T, C))

        if cfg.rotary:
            # packed batches pass per-document positions, so each document
            # sees the phases it would alone (JAX :639-645)
            pos = (positions if positions is not None
                   else torch.arange(T, device=x.device)[None, :])
            q, k = self._rope(q, pos), self._rope(k, pos)
        if G > 1:
            # jnp.repeat(t, G, axis=2): query head h reads KV head h // G.
            # Contiguous copies: the kernels take three strides per tensor,
            # which a stride-0 expand over the group cannot give; autograd
            # sums the per-head dk, dv over each group
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)

        if self.sparse is not None:
            # taken whenever a layout is configured (JAX :649-667): "pallas"
            # runs the block-sparse kernels (B5-B7), "gather" and "dense"
            # their plain paths, and "pallas" with a padding mask warns and
            # takes the dense path. No probability dropout on this route;
            # the output's applies
            kpm = None
            if mask is not None:
                kpm = torch.where(mask.bool(), 0.0,
                                  torch.finfo(torch.float32).min)
            y = self.sparse(q, k, v, key_padding_mask=kpm, causal=cfg.causal)
            return self.dropout(self.c_proj(y.reshape(B, T, C)), rng)

        # the flax model's gates (transformer_lm.py:689-725) unchanged, so
        # both packages route the same shapes; the kernel itself takes any T
        route, chunk = attention_route(
            cfg, T, mask=mask is not None, segments=segment_ids is not None,
            training_dropout=self.training and cfg.dropout > 0.0)
        if route == "chunked":
            from deepspeed_tpu_torch.ops.chunked_attention import \
                chunked_attention

            y = chunked_attention(q, k, v, causal=cfg.causal, chunk=chunk)
        elif route == "flash":
            from deepspeed_tpu_torch.ops.cuda.flash_attention import \
                flash_attention

            y = flash_attention(q, k, v, causal=cfg.causal,
                                segment_ids=segment_ids)
        else:
            y = einsum_attention(q, k, v, causal=cfg.causal, mask=mask,
                                 segment_ids=segment_ids, alibi=cfg.alibi,
                                 dropout=self.dropout, generator=rng)
        return self.dropout(self.c_proj(y.reshape(B, T, C)), rng)


class MLP(nn.Module):
    """``c_proj(act(c_fc(x)))``, or with ``gated_mlp`` (SwiGLU, JAX
    :774-778) ``c_proj(act(c_gate(x)) * c_fc(x))`` in the compute dtype."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.c_fc = Dense(cfg.n_embd, cfg.ffn_dim, cfg, bias=cfg.use_bias)
        self.c_gate = (Dense(cfg.n_embd, cfg.ffn_dim, cfg, bias=cfg.use_bias)
                       if cfg.gated_mlp else None)
        self.c_proj = Dense(cfg.ffn_dim, cfg.n_embd, cfg, bias=cfg.use_bias)
        self.act = _ACTIVATIONS[cfg.activation]
        self.dropout = Dropout(cfg.dropout)  # JAX :783

    def forward(self, x, rng=None):
        h = self.c_fc(x)
        if self.c_gate is not None:
            h = self.act(self.c_gate(x)) * h
        else:
            h = self.act(h)
        return self.dropout(self.c_proj(h), rng)


class Block(nn.Module):
    """Pre-norm transformer block (JAX ``Block``, :795-833): the dense MLP,
    or a ``moe.MoE`` when the config has experts; with
    ``parallel_residual`` (GPT-NeoX, GPT-J) attention and MLP both read the
    block's input, ``x + mlp(ln_2 x) + attn(ln_1 x)`` (GPT-J's one shared
    LayerNorm is ``ln_1`` and ``ln_2`` holding the same weights). Returns
    ``(x, l_aux)``, ``l_aux`` None for a dense MLP. Under stochastic depth
    (JAX :834-840) ``gate`` (a 0-dim bool) keeps the block's output or its
    input, and ``l_aux`` with it: the block always runs, so the shapes and
    the launches stay what a captured step recorded."""

    def __init__(self, cfg: GPTConfig):
        super().__init__()
        self.parallel_residual = cfg.parallel_residual
        self.ln_1 = _norm(cfg)
        self.attn = CausalSelfAttention(cfg)
        self.ln_2 = _norm(cfg)
        if cfg.is_moe:
            from deepspeed_tpu_torch.moe.layer import MoE

            self.mlp = MoE(
                cfg.n_embd, cfg.ffn_dim, num_experts=cfg.moe_num_experts,
                k=cfg.moe_top_k, capacity_factor=cfg.moe_capacity_factor,
                eval_capacity_factor=cfg.moe_eval_capacity_factor,
                min_capacity=cfg.moe_min_capacity,
                noisy_gate_policy=cfg.moe_noisy_gate_policy,
                drop_tokens=cfg.moe_drop_tokens, use_rts=cfg.moe_use_rts,
                gated_experts=cfg.moe_gated_experts, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype)
        else:
            self.mlp = MLP(cfg)

    def forward(self, x, mask=None, step=None, layer=0, segment_ids=None,
                positions=None, noise=None, rng=None, gate=None):
        """``noise``: this layer's gating draws (``MoE.forward``); ``rng``:
        the dropout masks' generator; ``gate``: the stochastic-depth draw
        (None: the block is kept)."""
        x_in = x
        a = self.attn(self.ln_1(x), mask=mask, step=step, layer=layer,
                      segment_ids=segment_ids, positions=positions, rng=rng)
        if not self.parallel_residual:
            x = x + a
        h = self.ln_2(x)
        l_aux = None
        if isinstance(self.mlp, MLP):
            y = self.mlp(h, rng=rng)
        else:
            y, l_aux, _ = self.mlp(h, noise=noise)
        x = x + y + a if self.parallel_residual else x + y
        if gate is not None:
            # the PLD form: identity skip, no 1/keep rescale
            x = torch.where(gate, x, x_in)
            if l_aux is not None:
                l_aux = torch.where(gate, l_aux, 0.0)
        return x, l_aux


class GPT(nn.Module):
    """Decoder-only LM: f32 logits ``[B, T, vocab]``, or with ``labels`` the
    mean next-token cross entropy (the model contract the engine trains
    against).

    Like a flax module, ``GPT(config)`` describes the model without
    allocating it: its parameters live on the meta device until
    ``init_inference`` materializes them on the card (or ``load_state_dict(
    ..., assign=True)`` supplies them). ``wpe`` exists only with
    ``learned_positions``; an untied model has ``lm_head`` (``[n_embd,
    vocab]``, JAX's layout) and ``lm_head_bias`` is ``[vocab]``."""

    def __init__(self, config: GPTConfig):
        super().__init__()
        self.config = config
        with torch.device("meta"):
            self.wte = VocabEmbed(config.vocab_size, config.n_embd, config)
            # BLOOM's word_embeddings_layernorm (JAX :1104-1105)
            self.ln_embed = _norm(config) if config.embed_layernorm else None
            self.wpe = (VocabEmbed(config.n_positions, config.n_embd, config)
                        if config.learned_positions else None)
            self.drop = Dropout(config.dropout)  # the embedding's, JAX :1130
            self.h = nn.ModuleList(Block(config)
                                   for _ in range(config.n_layer))
            self.ln_f = _norm(config)
            self.lm_head = (None if config.tie_word_embeddings
                            else nn.Parameter(torch.empty(
                                (config.n_embd, config.vocab_size),
                                dtype=config.param_dtype)))
            self.lm_head_bias = (nn.Parameter(torch.empty(
                config.vocab_size, dtype=config.param_dtype))
                if config.lm_head_bias else None)
        # ``block_hook(block, *args, **kwargs)``, when set, runs each block
        # in place of ``block(*args, **kwargs)``: ZeRO stage 3 gathers the
        # block's parameters there (runtime/zero/stage3.py)
        self.block_hook = None

    # the blocks ZeRO stage 3 cuts into units, and their names' prefix
    block_prefix = "h"

    @property
    def blocks(self) -> nn.ModuleList:
        return self.h

    def loss_weight_sum(self, input_ids=None, labels=None,
                        attention_mask=None, segment_ids=None, **_):
        """The sum of the loss's per-token weights for this batch (the
        denominator of ``cross_entropy_loss`` before its clamp to 1): the
        data-parallel engine all-reduces it to weight each rank's mean."""
        return _shifted_targets(labels, attention_mask, segment_ids)[1].sum()

    def _head_weight(self, dtype):
        """The LM head as ``[vocab, n_embd]`` in ``dtype``: the embedding
        table when tied, else a view of the cast ``lm_head``."""
        if self.lm_head is None:
            return self.wte.weight.to(dtype)
        return self.lm_head.to(dtype).t()

    def forward(self, input_ids, labels=None, attention_mask=None,
                segment_ids=None, positions=None, *, decode=False,
                cache: Optional[KVCache] = None,
                gating_noise: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None,
                pld_theta: Optional[torch.Tensor] = None):
        """Logits of ``input_ids`` ([B, T]), or the mean loss with ``labels``.

        With ``decode=True`` the call appends to a KV cache and returns
        ``(logits, cache)``: a new cache when ``cache`` is None (prefill),
        else ``cache`` itself, updated in place. ``attention_mask`` marks the
        real tokens (of LEFT-padded prompts when decoding). Packed training
        batches pass ``segment_ids`` (attention stays within a segment, and
        the loss skips cross-segment and pad targets) and ``positions``
        (learned or rotary positions that restart at each document).

        A mixture-of-experts model routes at the training capacity factor
        in training mode, else at the eval factor, and with ``labels`` adds
        ``moe_aux_loss_coef`` times the layers' mean load-balancing loss
        (JAX :1222-1226). ``gating_noise`` ([n_layer, kinds, B * T, E],
        ``MoE.noise_kinds``) is every layer's gating noise, drawn by the
        caller (the training engine); None routes without noise.

        In training mode ``dropout_generator`` draws the dropout masks (JAX's
        ``dropout`` stream; None: torch's default generator; a
        ``GlobalBatchDraws`` under data parallelism) and, with
        ``stochastic_mode`` and a ``pld_theta`` (a 0-dim f32 tensor, the
        progressive-layer-drop schedule's theta), one keep gate per layer,
        kept with ``pld_keep_probability``. ``remat`` recomputes each block
        in the backward under ``remat_policy``; the recompute reuses the
        forward's masks and gates."""
        cfg = self.config
        B, T = input_ids.shape
        dev = input_ids.device
        step = None
        if decode and not cfg.causal:
            raise NotImplementedError("decode path requires a causal model")
        if decode and segment_ids is not None:
            raise NotImplementedError(
                "packed-sequence segment_ids are a training-path feature; "
                "decode caches are per-sequence")
        if segment_ids is not None and cfg.sparse_attention is not None:
            raise NotImplementedError(
                "segment_ids with a block-sparse layout would silently "
                "change the layout's visibility; unpack the batch or "
                "disable sparse_attention")
        if segment_ids is not None and cfg.alibi:
            raise NotImplementedError(
                "ALiBi's absolute-position bias is not segment-aware; "
                "packed batches require rotary or learned positions")
        if decode and cache is None:
            cache = kv_cache(cfg, B, dev)
        pos = None
        if decode:
            step = cache.step(cfg, attention_mask.bool()
                              if attention_mask is not None else
                              torch.ones((B, T), dtype=torch.bool, device=dev))
            # a token's learned position is its count of real predecessors,
            # not its cache slot (left-padded ragged prompts); rotary phases
            # are the slots' positions (see CausalSelfAttention)
            if cfg.learned_positions and attention_mask is not None:
                am = attention_mask.long()
                pos = cache.position[:, None] + (am.cumsum(1) - 1).clamp_min(0)
                cache.position += am.sum(1)
            elif cfg.learned_positions:
                pos = cache.position[:, None] + torch.arange(T, device=dev)
                cache.position += T
        elif cfg.learned_positions:
            pos = (positions if positions is not None
                   else torch.arange(T, device=dev)[None, :])
        x = self.wte(input_ids)
        if self.ln_embed is not None:
            x = self.ln_embed(x)
        if self.wpe is not None:
            x = x + self.wpe(pos)
        x = self.drop(x, dropout_generator)
        gates = None
        if cfg.stochastic_mode and pld_theta is not None and self.training:
            # one Bernoulli draw per layer from the dropout stream, made
            # before the blocks, so a recompute sees the same gates
            from deepspeed_tpu_torch.runtime.activation_checkpointing \
                import base_generator

            keep = pld_keep_probability(
                torch.arange(cfg.n_layer, device=dev, dtype=torch.float32),
                cfg.n_layer, pld_theta)
            gates = torch.rand(cfg.n_layer,
                               generator=base_generator(dropout_generator),
                               device=dev) < keep
        # recomputation (nn.remat with the config's policy): the gating
        # noise comes in drawn and the dropout masks are handed back to the
        # recompute, so no RNG state is read (what a captured step may not)
        remat = cfg.remat and step is None and torch.is_grad_enabled()
        policy = _remat_policy(cfg.remat_policy) if remat else None
        l_aux = []
        for i, block in enumerate(self.h):
            run = (block if self.block_hook is None
                   else functools.partial(self.block_hook, block))
            noise = None if gating_noise is None else gating_noise[i]
            gate = None if gates is None else gates[i]
            if remat:
                from deepspeed_tpu_torch.runtime.activation_checkpointing \
                    import checkpoint

                x, aux = checkpoint(run, x, attention_mask, None, i,
                                    segment_ids, positions, noise,
                                    dropout_generator, gate, policy=policy)
            else:
                x, aux = run(x, mask=attention_mask, step=step, layer=i,
                             segment_ids=segment_ids, positions=positions,
                             noise=noise, rng=dropout_generator, gate=gate)
            if aux is not None:
                l_aux.append(aux)
        x = self.ln_f(x)
        if labels is not None:
            if decode:
                raise ValueError("labels and decode=True do not combine")
            chunk = fused_head_engages(cfg, B, T)
            if chunk:
                # the fused head + CE (JAX :1199-1213): the [B*T, V] logits
                # exist one token chunk at a time
                from deepspeed_tpu_torch.ops.cross_entropy import \
                    fused_linear_cross_entropy

                targets, w = _shifted_targets(labels, attention_mask,
                                              segment_ids)
                tied = self.lm_head is None
                head = (self.wte.weight if tied else self.lm_head).to(
                    cfg.dtype)
                loss = fused_linear_cross_entropy(
                    tied, chunk, x.to(cfg.dtype).reshape(-1, cfg.n_embd),
                    head, self.lm_head_bias, targets.reshape(-1),
                    w.reshape(-1))
            else:
                # compute-dtype logits (the unfused training head,
                # :1217-1218), the bias added after the product as in JAX
                logits = F.linear(x.to(cfg.dtype),
                                  self._head_weight(cfg.dtype))
                if self.lm_head_bias is not None:
                    logits = logits + self.lm_head_bias.to(cfg.dtype)
                loss = cross_entropy_loss(logits, labels, attention_mask,
                                          segment_ids)
            if cfg.is_moe:
                # the layers' mean load-balancing loss, with its coefficient
                loss = loss + cfg.moe_aux_loss_coef * torch.stack(
                    l_aux).sum() / cfg.n_layer
            return loss
        logits = _tied_head(x, self._head_weight(cfg.dtype))
        if self.lm_head_bias is not None:
            logits = logits + self.lm_head_bias.float()
        if decode:
            cache.index += T
            cache.length += T
            return logits, cache
        return logits


def materialize_gpt(model: GPT, device, generator: torch.Generator,
                    state_dict=None, dtype=None):
    """Give a meta-device ``GPT`` real weights on ``device``, in ``dtype``
    (default: the config's ``param_dtype``): the given ``state_dict``, or a
    random init drawn from ``generator`` in flax's distributions
    (truncated-normal lecun Dense kernels, the experts' 3-D kernels with
    the expert axis in their fan-in, normal 1/sqrt(C) embeddings, a
    normal(0.02) untied head, zero biases, unit norm scales). Random weights
    are drawn on the device, never allocated on the host; a ``state_dict``
    is cast on the host, so full precision never moves. Under the default
    dtype a module marked ``keep_param_dtype`` (the MoE gate, f32 in JAX
    whatever the model's ``param_dtype``) keeps its own; a serving dtype
    casts everything, as the JAX serving engine casts every leaf."""
    keep = dtype is None
    dtype = dtype or model.config.param_dtype
    if state_dict is not None:
        model.load_state_dict(state_dict, assign=True)
        _cast_params(model, dtype, keep)
        model.to(device)
        return
    from deepspeed_tpu_torch.moe.experts import StackedExperts

    model.to_empty(device=device)

    def lecun_(w, fan_in):
        # lecun_normal: cut at 2 std, std corrected for the cut
        std = fan_in ** -0.5 / 0.87962566103423978
        torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                    generator=generator)

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (LayerNorm, RMSNorm)):
                mod.weight.fill_(1.0)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, VocabEmbed):
                mod.weight.normal_(0.0, mod.weight.shape[1] ** -0.5,
                                   generator=generator)
            elif isinstance(mod, Dense):
                lecun_(mod.weight, mod.in_features)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, StackedExperts):
                for name in ("wi", "wg", "wo"):
                    if getattr(mod, name) is not None:
                        lecun_(getattr(mod, name), mod.fan_in(name))
                for bias in (mod.bi, mod.bo):
                    if bias is not None:
                        bias.zero_()
        # a GPT's untied head (BERT's model comes here too, and has none)
        if getattr(model, "lm_head", None) is not None:
            model.lm_head.normal_(0.0, 0.02, generator=generator)
        if getattr(model, "lm_head_bias", None) is not None:
            model.lm_head_bias.zero_()
    _cast_params(model, dtype, keep)


def _cast_params(model, dtype, keep: bool):
    """Every floating parameter to ``dtype``, but, with ``keep``, those of a
    module marked ``keep_param_dtype``."""
    for mod in model.modules():
        if keep and getattr(mod, "keep_param_dtype", False):
            continue
        mod._apply(lambda t: t.to(dtype) if t.is_floating_point() else t,
                   recurse=False)


def _tied_head(x, w):
    """``x @ w.T`` (``w`` the ``[vocab, n_embd]`` head) with compute-dtype
    operands and f32 accumulation and output
    (``lax.dot_general(..., preferred_element_type=f32)``)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        out = torch.mm(x2, w.t())
    elif x.is_cuda:
        # as [V, N] = w @ x^T every leading dimension stays a multiple of 8
        # for an odd vocab (GPT-2's 50257), so cuBLAS can take a Hopper
        # kernel; [N, V] directly leaves the f32 rows unaligned
        out = torch.mm(w, x2.t(), out_dtype=torch.float32).t()
    else:
        # the CPU has no mixed-dtype mm: the upcast operands hold the same
        # values, and the f32 product accumulates in f32
        out = torch.mm(x2.float(), w.float().t())
    return out.reshape(*x.shape[:-1], w.shape[0])


def _shifted_targets(labels, mask=None, segment_ids=None):
    """Next-token targets and f32 weights (``transformer_lm.py:1230``): the
    target of position i is labels[i + 1]; the last position gets a dummy
    target of weight 0, and so do positions whose next token is masked out,
    lies in another segment, or whose own segment is padding (0)."""
    b, t = labels.shape
    zero = labels.new_zeros((b, 1))
    targets = torch.cat([labels[:, 1:], zero], dim=1)
    if mask is not None:
        w = torch.cat([mask[:, 1:].float(),
                       torch.zeros((b, 1), device=labels.device)], dim=1)
    else:
        w = torch.cat([torch.ones((b, t - 1), device=labels.device),
                       torch.zeros((b, 1), device=labels.device)], dim=1)
    if segment_ids is not None:
        seg_next = torch.cat([segment_ids[:, 1:],
                              segment_ids.new_zeros((b, 1))], dim=1)
        w = w * ((segment_ids == seg_next) & (segment_ids != 0)).float()
    return targets, w


def cross_entropy_loss(logits, labels, mask=None, segment_ids=None):
    """Mean next-token cross entropy with the shift (``transformer_lm.py:1261``),
    f32 reductions over compute-dtype logits."""
    from deepspeed_tpu_torch.ops.cross_entropy import softmax_cross_entropy

    b, t = labels.shape
    targets, w = _shifted_targets(labels, mask, segment_ids)
    flat = logits.reshape(b * t, logits.shape[-1])
    return softmax_cross_entropy(flat, targets.reshape(b * t).long(),
                                 w.reshape(b * t))


def num_params(config: GPTConfig) -> int:
    """Parameter count (``transformer_lm.py:1273-1293``): GQA, the gated
    MLP, biases, norms, learned positions and the untied head and its
    bias. As in JAX, a mixture-of-experts config is counted as one dense
    MLP (no experts, no gate) and the embedding LayerNorm is left out: the
    count is the reference's, not the model's (``numel`` of the
    parameters counts those)."""
    cfg = config
    C, L, V = cfg.n_embd, cfg.n_layer, cfg.vocab_size
    D, H, Hkv, F_ = cfg.head_dim, cfg.n_head, cfg.kv_heads, cfg.ffn_dim
    b = 1 if cfg.use_bias else 0
    ab = b if cfg.attn_bias is None else (1 if cfg.attn_bias else 0)
    attn = C * (H + 2 * Hkv) * D + ab * (H + 2 * Hkv) * D + C * C + ab * C
    mlp = (3 if cfg.gated_mlp else 2) * C * F_ + b * (
        (2 if cfg.gated_mlp else 1) * F_ + C)
    norm_p = C * (2 if (cfg.norm == "layernorm" and cfg.use_bias) else 1)
    per_layer = attn + mlp + 2 * norm_p
    total = V * C + L * per_layer + norm_p
    if cfg.learned_positions:
        total += cfg.n_positions * C
    if not cfg.tie_word_embeddings:
        total += C * V
    if cfg.lm_head_bias:
        total += V
    return total
