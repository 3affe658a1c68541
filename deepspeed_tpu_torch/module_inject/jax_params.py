"""Carry GPT and BERT weights from the JAX package's parameter trees into
the port.

Counterpart of the GPT-2 mapping in ``deepspeed_tpu/module_inject/hf.py``
(``gpt2_params_from_hf`` :92 and ``gpt2_to_hf_state_dict`` :988), from the
flax tree straight to this package's ``state_dict``; the BERT mapping
follows ``deepspeed_tpu/models/bert.py``'s parameter names. A GPT tree may
have any shape the port's ``GPTConfig`` builds: GPT-2's, or the LLaMA-shaped
trunk that ``llama_from_hf`` (hf.py:499) configures (RMSNorm, ``c_gate``, no
biases, no ``wpe``, an untied ``lm_head``), BLOOM's ``ln_embed`` and the
mixture-of-experts MLP (``mlp/gate`` and ``mlp/experts``, as
``mixtral_from_hf``, hf.py:590, lays them out). The tree arrives as
nested dicts of numpy arrays (``jax.device_get(params)`` gives one), so
nothing here imports jax.

The mapping only renames and transposes leaves, so it carries any tree
shaped like the parameters: the parity tests also pass ``jax.grad``'s
gradient trees (and trained parameter trees) through it to compare
gradients leaf by leaf with the port's ``param.grad``, and
``adam_state_from_jax`` carries the Adam moments of a JAX-trained run into
the port's optimizer. (A JAX checkpoint file itself is flax msgpack, which
the port does not read.)
"""

from typing import Any, Dict

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    # f32 holds every bf16/f16 value exactly, and numpy has no bf16 of its own
    return torch.from_numpy(np.array(x, dtype=np.float32))


def gpt_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """flax ``GPT`` params (scanned ``h/block`` with a leading layer axis, or
    unscanned ``h_0``..``h_{n-1}``) -> ``deepspeed_tpu_torch`` ``GPT``
    state dict in f32.

    Dense kernels are ``[in, out]`` and become ``nn.Linear`` weights by
    transposition; ``c_attn`` stays fused, its output columns ordered
    q | kv-heads' k | kv-heads' v as in the flax model. A norm's ``scale``
    becomes ``weight`` (LayerNorm and RMSNorm alike). The tree decides
    which leaves exist: biases (``use_bias``, ``attn_bias``), ``c_gate``
    (the gated MLP), ``wpe`` (learned positions), the untied ``lm_head``
    (``[n_embd, vocab]`` in both packages), ``lm_head_bias`` and
    ``ln_embed``. A tied head has no entry of its own. In a mixture of
    experts the gate's kernel ``[M, E]`` becomes ``mlp.gate.weight``
    ``[E, M]`` and the experts' leaves keep the JAX layout, expert axis
    first (``mlp.experts.wi`` / ``wg`` ``[E, M, H]``, ``wo`` ``[E, H,
    M]``, ``bi`` ``[E, H]``, ``bo`` ``[E, M]``). A quantized tree (JAX's
    ``quantized_weights``: a block kernel is ``{"q", "scale"}``) gives the
    int8 ``weight_q`` (transposed) and the f32 ``weight_scale`` of the
    port's ``QuantizedDense``, bit for bit.
    """
    if "h" in params:
        stacked = params["h"]["block"]

        def layer(i):
            return _index_tree(stacked, i)
    else:
        def layer(i):
            return params[f"h_{i}"]

    sd = {"wte.weight": _tensor(params["wte"]["embedding"])}
    if "wpe" in params:
        sd["wpe.weight"] = _tensor(params["wpe"]["embedding"])
    _layer_norm(sd, "ln_f", params["ln_f"])
    if "ln_embed" in params:
        _layer_norm(sd, "ln_embed", params["ln_embed"])
    for name in ("lm_head", "lm_head_bias"):
        if name in params:
            sd[name] = _tensor(params[name])
    for i in range(cfg.n_layer):
        lp, p = layer(i), f"h.{i}"
        for ln in ("ln_1", "ln_2"):
            _layer_norm(sd, f"{p}.{ln}", lp[ln])
        for mod in ("attn", "mlp"):
            for name, dense in lp[mod].items():
                if name == "experts":
                    for leaf, x in dense.items():
                        sd[f"{p}.mlp.experts.{leaf}"] = _tensor(x)
                else:
                    _dense(sd, f"{p}.{mod}.{name}", dense)
    return sd


def _adam_node(state):
    """The node of an optax state tree that holds ``count``, ``mu`` and
    ``nu`` (``ScaleByAdamState`` inside ``optax.adamw``'s chain, or the
    Pallas ``FusedAdamWState``): a named tuple, searched depth first."""
    if all(hasattr(state, k) for k in ("count", "mu", "nu")):
        return state
    children = (state.values() if isinstance(state, dict)
                else state if isinstance(state, (tuple, list)) else ())
    for child in children:
        found = _adam_node(child)
        if found is not None:
            return found
    return None


def _bridge(cfg):
    """The model family's ``(state_dict_from_jax, exchange_layout)`` pair,
    by the config's class: ``BertConfig`` or ``GPTConfig``."""
    from deepspeed_tpu_torch.models.bert import BertConfig
    from deepspeed_tpu_torch.models.transformer_lm import GPTConfig

    if isinstance(cfg, BertConfig):
        return bert_state_dict_from_jax, bert_exchange_layout
    if isinstance(cfg, GPTConfig):
        return gpt_state_dict_from_jax, gpt_exchange_layout
    raise TypeError(f"no JAX bridge for {type(cfg).__name__}")


def state_dict_from_jax(tree: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """``bert_state_dict_from_jax`` for a ``BertConfig``, else
    ``gpt_state_dict_from_jax``."""
    return _bridge(cfg)[0](tree, cfg)


def adam_state_from_jax(opt_state, cfg) -> Dict[str, Any]:
    """The JAX engine's optax Adam state of a ``GPT`` or a
    ``BertForPreTraining`` (``count``, ``mu`` and ``nu`` over the scanned or
    unscanned parameter tree, as numpy: ``jax.device_get(
    engine._opt_state)``) -> the ``state_dict`` of the port's Adam
    optimizers (``AdamW``, ``FusedAdamW``): ``{"count": n, "state": {name:
    {"mu": t, "nu": t}}}``, named and laid out by ``state_dict_from_jax``'s
    map, in f32 (``load_state_dict`` casts to the moments' dtype)."""
    node = _adam_node(opt_state)
    if node is None:
        raise ValueError("no optax Adam state (count, mu, nu) in the tree")
    mu = state_dict_from_jax(node.mu, cfg)
    nu = state_dict_from_jax(node.nu, cfg)
    return {"count": int(np.asarray(node.count)),
            "state": {name: {"mu": mu[name], "nu": nu[name]} for name in mu}}


def _dense(sd, name, dense):
    kernel = dense["kernel"]
    if isinstance(kernel, dict) or hasattr(kernel, "items"):
        # quantized_weights: {"q": int8 [in, out], "scale": f32 [out]} ->
        # QuantizedDense's weight_q [out, in] and weight_scale
        q = torch.from_numpy(np.array(kernel["q"], dtype=np.int8))
        sd[f"{name}.weight_q"] = q.T.contiguous()
        sd[f"{name}.weight_scale"] = _tensor(kernel["scale"])
    else:
        sd[f"{name}.weight"] = _tensor(kernel).T.contiguous()
    if "bias" in dense:
        sd[f"{name}.bias"] = _tensor(dense["bias"])


def _layer_norm(sd, name, ln):
    """A LayerNorm's or RMSNorm's leaves (RMSNorm and a bias-free
    LayerNorm have only ``scale``)."""
    sd[f"{name}.weight"] = _tensor(ln["scale"])
    if "bias" in ln:
        sd[f"{name}.bias"] = _tensor(ln["bias"])


def bert_state_dict_from_jax(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """flax ``BertForPreTraining`` params (scanned ``encoder/layer`` with a
    leading layer axis, or unscanned ``encoder/layer_0``..) ->
    ``deepspeed_tpu_torch`` ``BertForPreTraining`` state dict in f32.

    Dense kernels are transposed into ``nn.Linear`` weights; the attention's
    ``qkv`` stays fused, its output columns ordered q | k | v. The MLM
    decoder is tied to ``word_embeddings``; ``mlm_bias`` is carried when the
    tree has one."""
    enc = params["encoder"]
    if "layer" in enc:
        def layer(i):
            return _index_tree(enc["layer"], i)
    else:
        def layer(i):
            return enc[f"layer_{i}"]

    sd = {}
    for name in ("word_embeddings", "position_embeddings",
                 "token_type_embeddings"):
        sd[f"{name}.weight"] = _tensor(params[name]["embedding"])
    _layer_norm(sd, "embeddings_ln", params["embeddings_ln"])
    for i in range(cfg.num_hidden_layers):
        lp, p = layer(i), f"encoder.layer.{i}"
        _dense(sd, f"{p}.attention.qkv", lp["attention"]["qkv"])
        _dense(sd, f"{p}.attention.output", lp["attention"]["output"])
        _dense(sd, f"{p}.intermediate", lp["intermediate"])
        _dense(sd, f"{p}.output", lp["output"])
        _layer_norm(sd, f"{p}.ln_attn", lp["ln_attn"])
        _layer_norm(sd, f"{p}.ln_out", lp["ln_out"])
    _dense(sd, "mlm_dense", params["mlm_dense"])
    _layer_norm(sd, "mlm_ln", params["mlm_ln"])
    if "mlm_bias" in params:
        sd["mlm_bias"] = _tensor(params["mlm_bias"])
    return sd


def _index_tree(tree, i):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


# ---------------------------------------------------------------------------
# the JAX flat layout of a model's parameters, for the gradient exchange
# ---------------------------------------------------------------------------
class ExchangeLayout:
    """The port's parameters laid out as the JAX engine flattens its
    parameter tree (``jax.tree.flatten`` of the flax ``GPT`` or
    ``BertForPreTraining`` params): the leaves in sorted-key order, each in
    flax layout (Dense kernels ``[in, out]``, the transpose of
    ``nn.Linear.weight``; ``c_attn`` and ``qkv`` fused q | k | v),
    concatenated into one flat buffer. With ``scan_layers`` a block leaf
    stacks the layers (``h/block/...`` or ``encoder/layer/...``, a leading
    layer axis); without, the blocks are ``h_0, h_1, h_10, ...`` (or
    ``encoder/layer_0, ...``) in string order.

    ``leaves`` is ``[(path, jax_shape)]`` in that order, ``offsets`` each
    leaf's start in the flat buffer, ``numel`` its length. Parameter ``i``
    (the port's order) lies at ``param_at[i] = (offset, jax_part_shape,
    transposed)``: its elements in the flat buffer, as the flax array of
    that layer. ``view(flat, i)`` is parameter i's view of a flat buffer in
    the port's shape (a strided view for a transposed kernel), so a copy
    into it writes the JAX order and a read of it reads it back. The
    quantisation blocks, 1-bit chunks and buckets of the compressed
    exchange are then taken over the same elements as in the JAX engine,
    and its error-feedback buffers have the JAX shapes."""

    def __init__(self, leaves, parts, n_params):
        self.leaves = [(path, tuple(shape)) for path, shape in leaves]
        self.offsets, at = [], 0
        for _, shape in self.leaves:
            self.offsets.append(at)
            at += int(np.prod(shape)) if shape else 1
        self.numel = at
        self.leaf_sizes = [int(np.prod(s)) if s else 1
                           for _, s in self.leaves]
        # parts[leaf] = [(param index, layer or None, transposed)]
        self.param_at = [None] * n_params
        self.leaf_params = []
        for li, ((_, shape), members) in enumerate(zip(self.leaves, parts)):
            self.leaf_params.append([i for i, _, _ in members])
            for i, layer, transposed in members:
                part = shape if layer is None else shape[1:]
                n = int(np.prod(part)) if part else 1
                off = self.offsets[li] + (0 if layer is None else layer * n)
                self.param_at[i] = (off, tuple(part), transposed)
        missing = [i for i, at_ in enumerate(self.param_at) if at_ is None]
        if missing:
            raise ValueError(f"parameters {missing} have no JAX leaf")

    @classmethod
    def identity(cls, named_shapes) -> "ExchangeLayout":
        """Each parameter its own leaf, in the given order and shape (the
        layout of a standalone optimizer)."""
        return cls([(name, tuple(shape)) for name, shape in named_shapes],
                   [[(i, None, False)] for i in range(len(named_shapes))],
                   len(named_shapes))

    def view(self, flat, i):
        off, part, transposed = self.param_at[i]
        n = int(np.prod(part)) if part else 1
        v = flat[off:off + n].view(part)
        return v.t() if transposed else v

    def leaf(self, flat, li):
        """Leaf ``li``'s contiguous slice of a flat buffer."""
        o = self.offsets[li]
        return flat[o:o + self.leaf_sizes[li]]


# (port module, port leaf) -> flax (module, leaf, transposed) in a block;
# a model has the ones its config builds (no biases under use_bias=False,
# c_gate only with gated_mlp)
_BLOCK_LEAVES = [
    ("attn.c_attn.bias", ("attn", "c_attn", "bias"), False),
    ("attn.c_attn.weight", ("attn", "c_attn", "kernel"), True),
    ("attn.c_proj.bias", ("attn", "c_proj", "bias"), False),
    ("attn.c_proj.weight", ("attn", "c_proj", "kernel"), True),
    ("ln_1.bias", ("ln_1", "bias"), False),
    ("ln_1.weight", ("ln_1", "scale"), False),
    ("ln_2.bias", ("ln_2", "bias"), False),
    ("ln_2.weight", ("ln_2", "scale"), False),
    ("mlp.c_fc.bias", ("mlp", "c_fc", "bias"), False),
    ("mlp.c_fc.weight", ("mlp", "c_fc", "kernel"), True),
    ("mlp.c_gate.bias", ("mlp", "c_gate", "bias"), False),
    ("mlp.c_gate.weight", ("mlp", "c_gate", "kernel"), True),
    ("mlp.c_proj.bias", ("mlp", "c_proj", "bias"), False),
    ("mlp.c_proj.weight", ("mlp", "c_proj", "kernel"), True),
    # a mixture of experts: the gate's kernel, the experts in JAX's layout
    ("mlp.gate.weight", ("mlp", "gate", "kernel"), True),
    ("mlp.experts.bi", ("mlp", "experts", "bi"), False),
    ("mlp.experts.bo", ("mlp", "experts", "bo"), False),
    ("mlp.experts.wg", ("mlp", "experts", "wg"), False),
    ("mlp.experts.wi", ("mlp", "experts", "wi"), False),
    ("mlp.experts.wo", ("mlp", "experts", "wo"), False),
]
# the untied head is [n_embd, vocab] in both packages: no transpose
_OUTER_LEAVES = [("lm_head", ("lm_head",), False),
                 ("lm_head_bias", ("lm_head_bias",), False),
                 ("ln_embed.bias", ("ln_embed", "bias"), False),
                 ("ln_embed.weight", ("ln_embed", "scale"), False),
                 ("ln_f.bias", ("ln_f", "bias"), False),
                 ("ln_f.weight", ("ln_f", "scale"), False),
                 ("wpe.weight", ("wpe", "embedding"), False),
                 ("wte.weight", ("wte", "embedding"), False)]
# a BertLayer's leaves and the rest of BertForPreTraining (bert.py's names)
_BERT_LAYER_LEAVES = [
    ("attention.output.bias", ("attention", "output", "bias"), False),
    ("attention.output.weight", ("attention", "output", "kernel"), True),
    ("attention.qkv.bias", ("attention", "qkv", "bias"), False),
    ("attention.qkv.weight", ("attention", "qkv", "kernel"), True),
    ("intermediate.bias", ("intermediate", "bias"), False),
    ("intermediate.weight", ("intermediate", "kernel"), True),
    ("ln_attn.bias", ("ln_attn", "bias"), False),
    ("ln_attn.weight", ("ln_attn", "scale"), False),
    ("ln_out.bias", ("ln_out", "bias"), False),
    ("ln_out.weight", ("ln_out", "scale"), False),
    ("output.bias", ("output", "bias"), False),
    ("output.weight", ("output", "kernel"), True),
]
_BERT_OUTER_LEAVES = [
    ("embeddings_ln.bias", ("embeddings_ln", "bias"), False),
    ("embeddings_ln.weight", ("embeddings_ln", "scale"), False),
    ("mlm_bias", ("mlm_bias",), False),
    ("mlm_dense.bias", ("mlm_dense", "bias"), False),
    ("mlm_dense.weight", ("mlm_dense", "kernel"), True),
    ("mlm_ln.bias", ("mlm_ln", "bias"), False),
    ("mlm_ln.weight", ("mlm_ln", "scale"), False),
    ("position_embeddings.weight", ("position_embeddings", "embedding"),
     False),
    ("token_type_embeddings.weight", ("token_type_embeddings", "embedding"),
     False),
    ("word_embeddings.weight", ("word_embeddings", "embedding"), False),
]


def gpt_exchange_layout(named_shapes, cfg) -> ExchangeLayout:
    """The ``ExchangeLayout`` of a ``GPT``'s parameters (``named_shapes``:
    ``(name, shape)`` in the port's order, as ``named_parameters()`` gives
    them) under ``cfg.scan_layers``. The inverse of
    ``gpt_state_dict_from_jax``'s map; it needs no jax. A leaf of
    ``_BLOCK_LEAVES`` is in the layout when layer 0 has it, and then every
    layer must."""
    return _exchange_layout(named_shapes, cfg.n_layer, cfg.scan_layers, "h",
                            ("h", "block"), lambda i: (f"h_{i}",),
                            _BLOCK_LEAVES, _OUTER_LEAVES)


def bert_exchange_layout(named_shapes, cfg) -> ExchangeLayout:
    """The ``ExchangeLayout`` of a ``BertForPreTraining``'s parameters under
    ``cfg.scan_layers``: ``encoder/layer/...`` stacked, or
    ``encoder/layer_{i}``, with the Dense kernels transposed as
    ``bert_state_dict_from_jax`` reads them (its inverse; no jax)."""
    return _exchange_layout(named_shapes, cfg.num_hidden_layers,
                            cfg.scan_layers, "encoder.layer",
                            ("encoder", "layer"),
                            lambda i: ("encoder", f"layer_{i}"),
                            _BERT_LAYER_LEAVES, _BERT_OUTER_LEAVES)


def exchange_layout(named_shapes, cfg) -> ExchangeLayout:
    """``bert_exchange_layout`` for a ``BertConfig``, else
    ``gpt_exchange_layout``."""
    return _bridge(cfg)[1](named_shapes, cfg)


def _exchange_layout(named_shapes, n_layer, scan, prefix, scanned_key,
                     unscanned_key, block_leaves, outer_leaves):
    """The layout of a model whose blocks are ``{prefix}.{i}`` in the port
    and ``scanned_key`` (stacked) or ``unscanned_key(i)`` in the flax
    tree; ``block_leaves`` and ``outer_leaves`` map the port's leaf names
    to flax paths, with whether the leaf is a transposed kernel."""
    index = {name: i for i, (name, _) in enumerate(named_shapes)}
    shapes = {name: tuple(s) for name, s in named_shapes}
    entries = {}  # jax path tuple -> (jax shape, [(param, layer, transposed)])

    def flax_shape(name, transposed):
        s = shapes[name]
        return tuple(reversed(s)) if transposed else s

    block_leaves = [leaf for leaf in block_leaves
                    if f"{prefix}.0.{leaf[0]}" in index]
    for i in range(n_layer):
        for port, path, transposed in block_leaves:
            name = f"{prefix}.{i}.{port}"
            if name not in index:
                raise ValueError(f"{name} is not a parameter of the model")
            part = flax_shape(name, transposed)
            if scan:
                key = scanned_key + path
                shape = (n_layer,) + part
                entries.setdefault(key, (shape, []))[1].append(
                    (index[name], i, transposed))
            else:
                entries[unscanned_key(i) + path] = (
                    part, [(index[name], None, transposed)])
    for name, path, transposed in outer_leaves:
        if name in index:
            entries[path] = (flax_shape(name, transposed),
                             [(index[name], None, transposed)])
    if len(index) != sum(len(m) for _, m in entries.values()):
        unknown = set(index) - {named_shapes[i][0] for _, m in entries.values()
                                for i, _, _ in m}
        raise ValueError(f"parameters without a JAX leaf: {sorted(unknown)}")
    order = sorted(entries)  # jax.tree.flatten sorts dict keys per level
    return ExchangeLayout([("/".join(k), entries[k][0]) for k in order],
                          [entries[k][1] for k in order], len(index))


def flatten_jax_tree(tree):
    """``[(path, array)]`` of a nested dict of arrays in
    ``jax.tree.flatten``'s order (sorted keys at each level)."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        out = []
        for k in sorted(tree.keys()):
            out += [((f"{k}/{p}" if p else str(k)), a)
                    for p, a in flatten_jax_tree(tree[k])]
        return out
    return [("", tree)]


def _state_fields(state):
    """A named tuple's fields as a dict (``OnebitAdamState`` and
    ``ZeroOneAdamState`` arrive from ``jax.device_get`` as named tuples)."""
    return {k: getattr(state, k) for k in state._fields}


def compressed_state_from_jax(opt_state, cfg, mode: str, rank: int,
                              world: int) -> Dict[str, Any]:
    """The JAX engine's optimizer state of a compressed gradient exchange
    (``jax.device_get(engine._opt_state)`` of a ``GPT`` or a
    ``BertForPreTraining``: ``(inner,)`` for
    the deferred exchange, ``(inner, err, serr)`` for int8, with the error
    feedback per leaf or per bucket, ``[k, ...]`` per worker; an
    ``OnebitAdamState`` / ``ZeroOneAdamState`` for the 1-bit family) ->
    the port's, for rank ``rank`` of ``world``: ``{"optimizer": the
    optimizer's state_dict, "grad_exchange": {"worker_error": [...],
    "server_error": [...]}}``, the error buffers as this rank's rows,
    flattened, in the exchange's order (buckets, or leaves in
    ``jax.tree.flatten`` order). ``CompressedExchange.load_state``
    (``runtime/compressed_exchange.py``) takes it."""
    def rows(tree):
        leaves = ([a for a in tree] if isinstance(tree, (tuple, list))
                  else [a for _, a in flatten_jax_tree(tree)])
        out = []
        for a in leaves:
            a = np.asarray(a, dtype=np.float32)
            if a.shape[0] != world:
                raise ValueError(f"error feedback of {a.shape[0]} workers "
                                 f"for a world of {world}")
            out.append(torch.from_numpy(a[rank].reshape(-1).copy()))
        return out

    if mode == "onebit":
        st = _state_fields(opt_state)
        m = state_dict_from_jax(st["exp_avg"], cfg)
        v = state_dict_from_jax(st["exp_avg_sq"], cfg)
        return {"optimizer": {
                    "count": int(np.asarray(st["count"])),
                    "state": {n: {"exp_avg": m[n], "exp_avg_sq": v[n]}
                              for n in m}},
                "grad_exchange": {"worker_error": rows(st["worker_error"]),
                                  "server_error": rows(st["server_error"])}}
    out = {"optimizer": adam_state_from_jax(opt_state[0], cfg)}
    if mode == "int8":
        out["grad_exchange"] = {"worker_error": rows(opt_state[1]),
                                "server_error": rows(opt_state[2])}
    return out


def shard_state_dict(state: Dict[str, Any], cfg, topo) -> Dict[str, Any]:
    """This process's tp/ep shard (its coordinates on the ``MeshTopology``
    ``topo``) of a whole ``state_dict`` in JAX's layout
    (``gpt_state_dict_from_jax``'s output). ``c_attn`` takes the
    head-aligned permutation of JAX's columns (``parallel/tensor.py``)."""
    from deepspeed_tpu_torch.parallel.tensor import (ParallelLayout,
                                                     shard_state_dict)

    return shard_state_dict(state, cfg, ParallelLayout.from_topology(topo))


def gather_state_dict(state: Dict[str, Any], cfg, topo) -> Dict[str, Any]:
    """The reverse of ``shard_state_dict``: every rank's shards gathered
    whole, ``c_attn`` back in JAX's ``[q | k | v]`` order (a collective over
    tp and ep: every rank calls it)."""
    from deepspeed_tpu_torch.parallel.tensor import (ParallelLayout,
                                                     gather_state_dict)

    return gather_state_dict(state, cfg, ParallelLayout.from_topology(topo))
