"""BERT encoder with the masked-LM head (counterpart of
``deepspeed_tpu/models/bert.py``).

The same config, math and parameter names as the flax model, in PyTorch
idiom: a layer loop over an ``nn.ModuleList`` in place of ``nn.scan``, and
full activation recomputation through ``torch.utils.checkpoint`` in place of
``nn.remat``. Parameters are stored in ``param_dtype`` and every op computes
in ``dtype``. With a ``sparse_attention`` config (a ``SparsityConfig``, set
from a DeepSpeed ``sparse_attention`` block by ``apply_sparse_attention``)
each layer's attention runs ``SparseSelfAttention``; the "pallas" kernel
selector routes it through the block-sparse kernels (B5-B7).

Like ``GPT``, ``BertForPreTraining(config)`` describes the model without
allocating it: its parameters live on the meta device until an engine
materializes them (``materialize_bert``) or ``load_state_dict(...,
assign=True)`` supplies them.
"""

import dataclasses
import math
from typing import Any

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from deepspeed_tpu_torch.models.transformer_lm import (Dense, LayerNorm,
                                                       VocabEmbed, _tied_head,
                                                       materialize_gpt)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The fields and defaults of ``deepspeed_tpu``'s ``BertConfig``, with
    torch dtypes. ``dropout`` is inert in eval mode; a model with
    ``dropout > 0`` raises ``NotImplementedError`` when it runs in training
    mode. ``scan_layers`` names the layout of the JAX parameter tree this
    config pairs with (one stacked ``encoder/layer`` or ``encoder/layer_{i}``);
    the port always loops."""

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
        if self.stochastic_mode:
            raise NotImplementedError(
                "BertConfig.stochastic_mode: stochastic depth is not ported to "
                "deepspeed_tpu_torch yet")
        if self.remat_policy != "full":
            raise NotImplementedError(
                f"remat_policy={self.remat_policy!r} is not ported yet; use "
                "'full'")
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


def _gelu(cfg, x):
    return F.gelu(x, approximate="tanh" if cfg.approximate_gelu else "none")


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        C = cfg.hidden_size
        self.qkv = Dense(C, 3 * C, cfg)
        self.output = Dense(C, C, cfg)
        self.sparse = None
        if cfg.sparse_attention is not None:
            from deepspeed_tpu_torch.ops.sparse_attention import \
                SparseSelfAttention

            self.sparse = SparseSelfAttention(
                cfg.sparse_attention,
                max_seq_length=cfg.max_position_embeddings)

    def forward(self, x, mask=None):
        cfg = self.cfg
        B, T, C = x.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        # views into the fused projection (q | k | v): the block-sparse
        # kernels read them through their strides
        q, k, v = (t.view(B, T, H, D) for t in self.qkv(x).split(C, dim=-1))
        if self.sparse is not None:
            # the padding mask becomes an additive key-padding mask; with
            # one, the "pallas" selection takes the dense path (and warns)
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
            y = torch.matmul(att, v.transpose(1, 2)).transpose(1, 2)
            y = y.reshape(B, T, C)
        return self.output(y)


class BertLayer(nn.Module):
    """Post-LN layer, as the original BERT."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = BertSelfAttention(cfg)
        self.ln_attn = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size, cfg)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size, cfg)
        self.ln_out = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg)

    def forward(self, x, mask=None):
        x = self.ln_attn(x + self.attention(x, mask))
        h = self.output(_gelu(self.cfg, self.intermediate(x)))
        return self.ln_out(x + h)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList(BertLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))

    def forward(self, x, mask=None):
        # full recomputation: each layer keeps only its input for the
        # backward (nn.remat with no policy)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layer:
            if remat:
                # no RNG state to keep (dropout is refused in training),
                # and reading the CUDA RNG state is what a captured step may
                # not
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, mask, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                x = layer(x, mask)
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
            self.token_type_embeddings = VocabEmbed(cfg.type_vocab_size,
                                                    cfg.hidden_size, cfg)
            self.embeddings_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg)
            self.encoder = BertEncoder(cfg)
            self.mlm_dense = Dense(cfg.hidden_size, cfg.hidden_size, cfg)
            self.mlm_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg)
            if cfg.use_mlm_bias:
                self.mlm_bias = nn.Parameter(
                    torch.zeros(cfg.vocab_size, dtype=cfg.param_dtype))

    def loss_weight_sum(self, input_ids=None, labels=None, **_):
        """The count of labelled positions (the denominator of
        ``masked_lm_loss`` before its clamp to 1)."""
        return (labels != -100).float().sum()

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        cfg = self.config
        B, T = input_ids.shape
        if self.training and cfg.dropout > 0:
            raise NotImplementedError(
                f"dropout={cfg.dropout} in training: dropout is not ported "
                "yet (eval mode ignores it)")
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        pos = torch.arange(T, device=input_ids.device)[None, :]
        x = (self.word_embeddings(input_ids) + self.position_embeddings(pos)
             + self.token_type_embeddings(token_type_ids))
        x = self.embeddings_ln(x)
        x = self.encoder(x, attention_mask)

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
