"""Carry GPT weights from the JAX package's parameter tree into the port.

Counterpart of the GPT-2 mapping in ``deepspeed_tpu/module_inject/hf.py``
(``gpt2_params_from_hf`` :92 and ``gpt2_to_hf_state_dict`` :988), from the
flax tree straight to this package's ``state_dict``. The tree arrives as
nested dicts of numpy arrays (``jax.device_get(params)`` gives one), so
nothing here imports jax.

The mapping only renames and transposes leaves, so it carries any tree
shaped like the parameters: the parity tests also pass ``jax.grad``'s
gradient trees (and trained parameter trees) through it to compare
gradients leaf by leaf with the port's ``param.grad``.
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


def _index_tree(tree, i):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
