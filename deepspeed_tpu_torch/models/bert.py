"""BERT encoder with the masked-LM head (counterpart of
``deepspeed_tpu/models/bert.py``).

The same config, math and parameter names as the flax model, in PyTorch
idiom: a layer loop over an ``nn.ModuleList`` in place of ``nn.scan``, and
recomputation under ``remat_policy`` through ``runtime/activation_checkpointing``
(the GPT's ``_remat_policy``) in place of ``nn.remat``. Parameters are stored
in ``param_dtype`` and every op computes in ``dtype``. With a
``sparse_attention`` config (a ``SparsityConfig``, set from a DeepSpeed
``sparse_attention`` block by ``apply_sparse_attention``) each layer's
attention runs ``SparseSelfAttention``; the "pallas" kernel selector routes
it through the block-sparse kernels (B5-B7), under dropout too.

In training mode, dropout acts at JAX's sites (the embedding after
``embeddings_ln``, JAX :239; per layer the attention probabilities on the
einsum path only, :107, the attention output, :111, and the MLP output,
:130), its masks drawn through ``bernoulli_mask`` from the generator handed
to ``forward``; ``stochastic_mode`` gates each layer with one draw per layer
(JAX :132-136), as the GPT does.

Like ``GPT``, ``BertForPreTraining(config)`` describes the model without
allocating it: its parameters live on the meta device until an engine
materializes them (``materialize_bert``) or ``load_state_dict(...,
assign=True)`` supplies them.
"""

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from deepspeed_tpu_torch.models.transformer_lm import (Dense, Dropout,
                                                       LayerNorm, VocabEmbed,
                                                       _remat_policy,
                                                       _tied_head,
                                                       materialize_gpt,
                                                       pld_keep_probability)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The fields and defaults of ``deepspeed_tpu``'s ``BertConfig``, with
    torch dtypes. ``dropout`` and ``stochastic_mode`` act in training mode
    only. ``remat_policy`` takes JAX's four names (``full``, ``selective``,
    ``save_dots``, ``save_nothing_but_flash``; the last is ``full`` on a
    BERT, which has no flash attention). ``scan_layers`` names the layout of
    the JAX parameter tree this config pairs with (one stacked
    ``encoder/layer`` or ``encoder/layer_{i}``); the port always loops."""

    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    approximate_gelu: bool = True
    use_mlm_bias: bool = False
    dropout: float = 0.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = False
    remat_policy: str = "full"
    scan_layers: bool = True
    sparse_attention: Any = None
    stochastic_mode: bool = False

    def __post_init__(self):
        _remat_policy(self.remat_policy)  # raises for an unknown name
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be divisible by "
                f"num_attention_heads ({self.num_attention_heads})")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


BERT_SIZES = {
    "bert-base": dict(hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072),
    "bert-large": dict(hidden_size=1024, num_hidden_layers=24,
                       num_attention_heads=16, intermediate_size=4096),
}


def bert_config(name: str, **overrides) -> BertConfig:
    base = dict(BERT_SIZES[name])
    base.update(overrides)
    return BertConfig(**base)


class TypeEmbed(VocabEmbed):
    """The token-type table (flax ``nn.Embed``, a few rows), its rows taken
    by a one-hot product: the values are the table's rows exactly, and the
    backward is a matrix product. Through the gather, this table alone of
    BERT-Large's parameters parted a captured step from its eager twin on
    an H100 (last bits, at [1, 4096] and [8, 512], every position of type
    0), although the gather's backward alone repeats bit for bit at that
    shape, eager and captured, as it does for the word table with 490
    copies of one id (``chip_smoke.py``'s ``embedding_backward_repeats``).
    The cause is not found; through the product the table stays equal."""

    def forward(self, ids):
        w = self.weight.to(self.compute_dtype)
        rows = torch.arange(w.shape[0], device=ids.device)
        return (ids[..., None] == rows).to(w.dtype) @ w


def _gelu(cfg, x):
    return F.gelu(x, approximate="tanh" if cfg.approximate_gelu else "none")


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        self.qkv = Dense(C, 3 * C, cfg)
        self.output = Dense(C, C, cfg)
        # the probabilities' (einsum path) and the output's dropout
        self.dropout = Dropout(cfg.dropout)
        self.sparse = None
        if cfg.sparse_attention is not None:
            from deepspeed_tpu_torch.ops.sparse_attention import \
                SparseSelfAttention

            self.sparse = SparseSelfAttention(
                cfg.sparse_attention,
                max_seq_length=cfg.max_position_embeddings)

    def forward(self, x, mask=None, rng=None):
        cfg = self.cfg
        B, T, C = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        # views into the fused projection (q | k | v): the block-sparse
        # kernels read them through their strides
        q, k, v = (t.view(B, T, H, D) for t in self.qkv(x).split(C, dim=-1))
        if self.sparse is not None:
            # the padding mask becomes an additive key-padding mask; with
            # one, the "pallas" selection takes the dense path (and warns).
            # No probability dropout on this route (JAX :87-91): the kernels
            # run under dropout as they do without it
            kpm = None
            if mask is not None:
                kpm = torch.where(mask.bool(), 0.0,
                                  torch.finfo(torch.float32).min)
            y = self.sparse(q, k, v, key_padding_mask=kpm).reshape(B, T, C)
        else:
            att = torch.matmul(q.transpose(1, 2),
                               k.permute(0, 2, 3, 1)) / math.sqrt(D)
            if mask is not None:
                att = att.masked_fill(~mask.bool()[:, None, None, :],
                                      torch.finfo(att.dtype).min)
            att = torch.softmax(att.float(), dim=-1).to(cfg.dtype)
            att = self.dropout(att, rng)
            y = torch.matmul(att, v.transpose(1, 2)).transpose(1, 2)
            y = y.reshape(B, T, C)
        return self.dropout(self.output(y), rng)


class BertLayer(nn.Module):
    """Post-LN layer, as the original BERT. ``rng``: the dropout masks'
    generator; ``gate``: the stochastic-depth draw (a 0-dim bool, None: the
    layer is kept), which keeps the layer's output or its input (JAX
    :132-136). The layer always runs, so a captured step's shapes and
    launches do not depend on the gate."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg)
        self.ln_attn = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size, cfg)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size, cfg)
        self.ln_out = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, mask=None, rng=None, gate=None):
        x_in = x
        x = self.ln_attn(x + self.attention(x, mask, rng))
        h = self.output(_gelu(self.cfg, self.intermediate(x)))
        x = self.ln_out(x + self.dropout(h, rng))
        if gate is not None:
            # the PLD form: identity skip, no 1/keep rescale
            x = torch.where(gate, x, x_in)
        return x


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, x, mask=None, rng=None, gates=None, block_hook=None):
        """``rng``: the dropout masks' generator; ``gates``: one
        stochastic-depth draw per layer (None: every layer is kept);
        ``block_hook(layer, *args)``, when given, runs each layer in place
        of ``layer(*args)``, inside the checkpointed call (ZeRO stage 3
        gathers there, so a recompute gathers again). Under ``remat`` each
        layer is recomputed in the backward under ``remat_policy``, with the
        forward's masks handed back and the same gates, so no generator
        state is read (what a captured step may not)."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        policy = _remat_policy(cfg.remat_policy) if remat else None
        for i, layer in enumerate(self.layer):
            run = (layer if block_hook is None
                   else functools.partial(block_hook, layer))
            gate = None if gates is None else gates[i]
            if remat:
                from deepspeed_tpu_torch.runtime.activation_checkpointing \
                    import checkpoint

                x = checkpoint(run, x, mask, rng, gate, policy=policy)
            else:
                x = run(x, mask, rng, gate)
        return x


class _TiedDecoder(torch.autograd.Function):
    """``h @ w.T`` with compute-dtype operands and f32 logits (the flax
    model's ``dot_general(..., preferred_element_type=f32)``). The backward
    takes the f32 cotangent to the compute dtype, as the operands are, and
    returns compute-dtype gradients."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _tied_head(h, w)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g2 = g.to(h.dtype).reshape(-1, g.shape[-1])
        dh = (g2 @ w).reshape(h.shape)
        dw = g2.t() @ h.reshape(-1, h.shape[-1])
        return dh, dw


class BertForPreTraining(nn.Module):
    """BERT with the MLM head tied to the token embedding. ``forward``
    returns the masked-LM loss when ``labels`` are given (-100 = ignore),
    else f32 logits ``[B, T, vocab]``."""

    def __init__(self, config: BertConfig):
        super().__init__()
        self.config = config
        cfg = config
        with torch.device("meta"):
            self.word_embeddings = VocabEmbed(cfg.vocab_size, cfg.hidden_size, cfg)
            self.position_embeddings = VocabEmbed(cfg.max_position_embeddings,
                                                  cfg.hidden_size, cfg)
            self.token_type_embeddings = TypeEmbed(cfg.type_vocab_size,
                                                    cfg.hidden_size, cfg)
            self.embeddings_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg)
            self.drop = Dropout(cfg.dropout)  # the embedding's, JAX :239
            self.encoder = BertEncoder(cfg)
            self.mlm_dense = Dense(cfg.hidden_size, cfg.hidden_size, cfg)
            self.mlm_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg)
            if cfg.use_mlm_bias:
                self.mlm_bias = nn.Parameter(
                    torch.zeros(cfg.vocab_size, dtype=cfg.param_dtype))
        # ``block_hook(layer, *args)``, when set, runs each encoder layer
        # (``BertEncoder.forward``): ZeRO stage 3 gathers the layer's
        # parameters there (runtime/zero/stage3.py)
        self.block_hook = None

    # the blocks ZeRO stage 3 cuts into units, and their names' prefix
    block_prefix = "encoder.layer"

    @property
    def blocks(self) -> nn.ModuleList:
        return self.encoder.layer

    def loss_weight_sum(self, input_ids=None, labels=None, **_):
        """The count of labelled positions (the denominator of
        ``masked_lm_loss`` before its clamp to 1)."""
        return (labels != -100).float().sum()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None, *,
                dropout_generator: Optional[torch.Generator] = None,
                pld_theta: Optional[torch.Tensor] = None):
        """In training mode ``dropout_generator`` draws the dropout masks
        (JAX's ``dropout`` stream; None: torch's default generator; a
        ``GlobalBatchDraws`` under data parallelism) and, with
        ``stochastic_mode`` and a ``pld_theta`` (a 0-dim f32 tensor, the
        progressive-layer-drop schedule's theta), one keep gate per layer,
        kept with ``pld_keep_probability``."""
        cfg = self.config
        B, T = input_ids.shape
        dev = input_ids.device
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(T, device=dev)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        x = self.drop(self.embeddings_ln(x), dropout_generator)
        gates = None
        if cfg.stochastic_mode and pld_theta is not None and self.training:
            # one Bernoulli draw per layer from the dropout stream, made
            # before the layers, so a recompute sees the same gates; equal
            # on every rank
            from deepspeed_tpu_torch.runtime.activation_checkpointing \
                import base_generator

            L = cfg.num_hidden_layers
            keep = pld_keep_probability(
                torch.arange(L, device=dev, dtype=torch.float32), L,
                pld_theta)
            gates = torch.rand(L, generator=base_generator(dropout_generator),
                               device=dev) < keep
        x = self.encoder(x, attention_mask, dropout_generator, gates,
                         self.block_hook)

        h = self.mlm_ln(_gelu(cfg, self.mlm_dense(x)))
        logits = _TiedDecoder.apply(h.to(cfg.dtype),
                                    self.word_embeddings.weight.to(cfg.dtype))
        if cfg.use_mlm_bias:
            logits = logits + self.mlm_bias.float()
        if labels is None:
            return logits
        return masked_lm_loss(logits, labels)


def masked_lm_loss(logits, labels):
    """Mean cross entropy over positions where labels != -100, in f32."""
    logits = logits.float()
    valid = labels != -100
    safe_labels = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe_labels[..., None].long())[..., 0]
    m = valid.float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def materialize_bert(model: BertForPreTraining, device, generator,
                     state_dict=None, dtype=None):
    """Give a meta-device ``BertForPreTraining`` real weights on ``device``:
    ``materialize_gpt``'s rules (the given ``state_dict``, or flax's
    distributions for Dense, embedding and LayerNorm parameters drawn from
    ``generator``), and a zero ``mlm_bias``."""
    materialize_gpt(model, device, generator, state_dict=state_dict,
                    dtype=dtype)
    if state_dict is None and model.config.use_mlm_bias:
        with torch.no_grad():
            model.mlm_bias.zero_()
