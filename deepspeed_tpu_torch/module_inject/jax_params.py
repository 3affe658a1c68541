"""Carry GPT and BERT weights from the JAX package's parameter trees into
the port.

Counterpart of the GPT-2 mapping in ``deepspeed_tpu/module_inject/hf.py``
(``gpt2_params_from_hf`` :92 and ``gpt2_to_hf_state_dict`` :988), from the
flax tree straight to this package's ``state_dict``; the BERT mapping
follows ``deepspeed_tpu/models/bert.py``'s parameter names. The tree arrives as
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
    q | k | v as in the flax model. LayerNorm ``scale`` becomes ``weight``.
    The LM head is tied to ``wte`` and has no entry of its own.
    """
    if "h" in params:
        stacked = params["h"]["block"]

        def layer(i):
            return _index_tree(stacked, i)
    else:
        def layer(i):
            return params[f"h_{i}"]

    sd = {
        "wte.weight": _tensor(params["wte"]["embedding"]),
        "wpe.weight": _tensor(params["wpe"]["embedding"]),
        "ln_f.weight": _tensor(params["ln_f"]["scale"]),
        "ln_f.bias": _tensor(params["ln_f"]["bias"]),
    }
    for i in range(cfg.n_layer):
        lp, p = layer(i), f"h.{i}"
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"] = _tensor(lp[ln]["scale"])
            sd[f"{p}.{ln}.bias"] = _tensor(lp[ln]["bias"])
        for mod, name in (("attn", "c_attn"), ("attn", "c_proj"),
                          ("mlp", "c_fc"), ("mlp", "c_proj")):
            dense = lp[mod][name]
            sd[f"{p}.{mod}.{name}.weight"] = _tensor(dense["kernel"]).T.contiguous()
            sd[f"{p}.{mod}.{name}.bias"] = _tensor(dense["bias"])
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


def adam_state_from_jax(opt_state, cfg) -> Dict[str, Any]:
    """The JAX engine's optax Adam state of a ``GPT`` (``count``, ``mu``
    and ``nu`` over the scanned or unscanned parameter tree, as numpy:
    ``jax.device_get(engine._opt_state)``) -> the ``state_dict`` of the
    port's Adam optimizers (``AdamW``, ``FusedAdamW``): ``{"count": n,
    "state": {name: {"mu": t, "nu": t}}}``, named and laid out by
    ``gpt_state_dict_from_jax``'s map, in f32 (``load_state_dict`` casts
    to the moments' dtype)."""
    node = _adam_node(opt_state)
    if node is None:
        raise ValueError("no optax Adam state (count, mu, nu) in the tree")
    mu = gpt_state_dict_from_jax(node.mu, cfg)
    nu = gpt_state_dict_from_jax(node.nu, cfg)
    return {"count": int(np.asarray(node.count)),
            "state": {name: {"mu": mu[name], "nu": nu[name]} for name in mu}}


def _dense(sd, name, dense):
    sd[f"{name}.weight"] = _tensor(dense["kernel"]).T.contiguous()
    sd[f"{name}.bias"] = _tensor(dense["bias"])


def _layer_norm(sd, name, ln):
    sd[f"{name}.weight"] = _tensor(ln["scale"])
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
