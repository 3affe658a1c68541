"""The inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

``init_inference`` wraps a ``GPT`` for serving on one card: the weights are
materialized on the device in the serving dtype, ``forward`` returns f32
logits and ``generate`` runs prefill plus a per-token decode loop over the
dense KV cache. The JAX engine compiles prefill and a decode scan with jit;
here both run eagerly (CUDA graphs are later work).

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when torch sees no card. Pass ``device="cpu"`` to run on the host.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer_lm import GPT, materialize_gpt
from deepspeed_tpu_torch.utils.logging import log_dist

_DTYPES = {None: None, "fp16": torch.float16, "float16": torch.float16,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}


def prefill_chunk_spans(model_cfg, T: int):
    """Spans of an exact chunked prefill. The port has only the dense cache,
    where one pass is always exact, so this is always None (the ring cache
    that needs spans is not ported)."""
    return None


def init_inference(model, config: Optional[Dict[str, Any]] = None,
                   mp_size: int = 1, dtype=None, checkpoint: Optional[str] = None,
                   replace_with_kernel_inject: bool = True, seed: int = 0,
                   ep_size: int = 1, *, device=None, state_dict=None):
    """Build an InferenceEngine (``deepspeed_tpu.init_inference``'s
    signature, plus where to run and, optionally, the weights).

    ``device``: None means ``"cuda"``. ``state_dict``: weights for the model
    (e.g. from ``module_inject.jax_params.gpt_state_dict_from_jax``); None
    draws them at random from ``seed``.
    """
    config = dict(config or {})
    config.setdefault("tensor_parallel", {"tp_size": mp_size})
    if ep_size != 1:
        config["moe"] = dict(config.get("moe") or {}, ep_size=ep_size)
    if dtype is not None:
        config["dtype"] = dtype
    if checkpoint is not None:
        config["checkpoint"] = checkpoint
    config["replace_with_kernel_inject"] = replace_with_kernel_inject
    return InferenceEngine(model, config, seed=seed, device=device,
                           state_dict=state_dict)


class InferenceEngine:
    def __init__(self, model, config: Dict[str, Any], seed: int = 0,
                 device=None, state_dict=None):
        if not isinstance(model, GPT):
            raise NotImplementedError(
                f"the port serves deepspeed_tpu_torch GPT models; "
                f"{type(model).__name__} (HF import included) is not ported")
        tp_size = int(config.get("tensor_parallel", {}).get("tp_size", 1))
        ep_size = int(config.get("moe", {}).get("ep_size", 1))
        for what, unported in (
                ("tensor parallelism (tp_size > 1)", tp_size != 1),
                ("expert parallelism (ep_size > 1)", ep_size != 1),
                ("checkpoint loading", bool(config.get("checkpoint"))),
                ("dtype='int8'", config.get("dtype") == "int8"),
                ("the int8 KV cache ('kv_cache')",
                 config.get("kv_cache") is not None),
                ("'decode_chunk' (a jit dispatch lever)",
                 "decode_chunk" in config)):
            if unported:
                raise NotImplementedError(f"{what} is not ported yet")
        if config.get("dtype") not in _DTYPES:
            raise ValueError(f"unknown dtype {config.get('dtype')!r}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "init_inference runs on a CUDA card by default and torch "
                    "sees none; pass device='cpu' to serve on the host")
            device = "cuda"
        self.device = torch.device(device)
        self.module = model
        self.dtype = _DTYPES[config.get("dtype")]
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._materialize(state_dict)
        log_dist(f"InferenceEngine: device={self.device}, dtype={self.dtype}",
                 ranks=[0])

    def _materialize(self, state_dict):
        """Place the weights on the device in the serving dtype (the model's
        ``param_dtype`` unless fp16/bf16 serving asks to cast)."""
        half = self.dtype in (torch.float16, torch.bfloat16)
        materialize_gpt(self.module, self.device, self._generator,
                        state_dict=state_dict,
                        dtype=self.dtype if half else None)
        self.module.eval()

    def _ids(self, input_ids):
        return torch.as_tensor(input_ids).to(self.device, torch.long)

    @torch.inference_mode()
    def forward(self, input_ids):
        """f32 logits ``[B, T, vocab]`` of a full forward."""
        return self.module(self._ids(input_ids))

    __call__ = forward

    @torch.inference_mode()
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, attention_mask=None):
        """Greedy (``temperature == 0``) or sampled generation; returns
        ``[B, max_new_tokens]`` token ids.

        Ragged batches pass ``attention_mask`` (1 = real token); prompts are
        LEFT-aligned here so that real tokens sit contiguously in the cache,
        as in the JAX engine."""
        cfg = self.module.config
        ids = self._ids(input_ids)
        if attention_mask is not None:
            ids_np = ids.cpu().numpy()
            m_np = np.asarray(attention_mask.cpu() if torch.is_tensor(
                attention_mask) else attention_mask).astype(bool)
            if m_np.shape != ids_np.shape:
                raise ValueError(
                    f"attention_mask shape {m_np.shape} != input_ids "
                    f"shape {ids_np.shape}")
            if not m_np.any(axis=1).all():
                empty = np.where(~m_np.any(axis=1))[0].tolist()
                raise ValueError(
                    f"attention_mask rows {empty} have no valid tokens; "
                    "an empty prompt cannot seed generation")
            T = ids_np.shape[1]
            out_ids = np.zeros_like(ids_np)
            out_m = np.zeros_like(m_np)
            for b in range(ids_np.shape[0]):
                vtok = ids_np[b][m_np[b]]
                out_ids[b, T - len(vtok):] = vtok
                out_m[b, T - len(vtok):] = True
            ids = torch.from_numpy(out_ids).to(self.device)
            attention_mask = torch.from_numpy(out_m).to(self.device)
        if max_new_tokens < 0:
            raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
        if max_new_tokens == 0:
            return torch.zeros((ids.shape[0], 0), dtype=torch.long,
                               device=self.device)
        if ids.shape[1] + max_new_tokens > cfg.n_positions:
            raise ValueError(
                f"prompt ({ids.shape[1]}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the KV cache capacity (n_positions={cfg.n_positions})")
        if attention_mask is None:
            attention_mask = torch.ones(ids.shape, dtype=torch.bool,
                                        device=self.device)

        logits, cache = self.module(ids, attention_mask=attention_mask,
                                    decode=True)
        tok = self._next_token(logits[:, -1], temperature)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, cache = self.module(tok[:, None], decode=True, cache=cache)
            tok = self._next_token(logits[:, -1], temperature)
            out.append(tok)
        return torch.stack(out, dim=1)

    def _next_token(self, logits, temperature):
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1,
                                     generator=self._generator)[:, 0]
        # first index among equal maxima, as jnp.argmax
        return torch.argmax(logits, dim=-1)

    @property
    def params(self):
        return self.module.state_dict()
