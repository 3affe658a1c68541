"""The inference engine (counterpart of ``deepspeed_tpu/inference/engine.py``).

``init_inference`` wraps a ``GPT`` for serving on one card: the weights are
materialized on the device in the serving dtype, ``forward`` returns f32
logits and ``generate`` runs prefill, then decodes over the KV cache
in runs of ``decode_chunk`` steps (default 32), as the JAX engine does
(``generate``, ``deepspeed_tpu/inference/engine.py:650-680``): each run is
the largest power of two of steps that fits in ``min(chunk, remaining)``,
so at most log2(chunk) + 1 run lengths ever occur. The JAX engine compiles
each run as one scan; here each run is a step function of tensors
(``runtime/compiled_step.CompiledStep``), called directly on the CPU and, on
the card, captured as one CUDA graph per (batch size, run length, greedy or
sampled) and replayed (a CUDA graph has no ``lax.cond``, so greedy and
sampled decoding are two graphs). The engine keeps one KV cache per batch
size, reset at each prefill, whose buffers the graphs read and write; the
host advances the cache's ``length`` by k after each run. Sampling draws
from the engine's own generator, registered with each graph. Prefill and
``forward`` run eagerly.

A model whose ``sparse_attention`` layout is a causal window (+ leading
globals) decodes from the ring KV cache (``ring_engaged``;
``models/transformer_lm.py`` ``RingKVCache``), which reproduces the
training block-sparse attention: a prompt longer than the ring prefills in
block-aligned spans (``prefill_chunk_spans``), and a rotary model streams
past ``n_positions``. Another layout decodes over the dense cache, with a
warning.

``init_inference(checkpoint=...)`` serves weights the training engine
saved (``_load_checkpoint`` of the JAX engine, :681): a model-states file
of ``save_checkpoint``, a tag directory (its model-states file checked
against the manifest) or a ``save_16bit_model`` file.

A mixture-of-experts model serves at its eval capacity factor (the module
is in eval mode) with every expert on the card; its gating reads nothing
back to the host, so the decode runs capture like a dense model's.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when torch sees no card. Pass ``device="cpu"`` to run on the host.
"""

import collections
import functools
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.models.transformer_lm import (GPT, KVCache,
                                                       kv_cache,
                                                       materialize_gpt)
from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils import (
    ring_engaged, ring_storage_len)
from deepspeed_tpu_torch.runtime import checkpoint_manifest as ckpt_manifest
from deepspeed_tpu_torch.runtime import moe_checkpoint as moe_ckpt
from deepspeed_tpu_torch.runtime.checkpoint_engine import (MODEL_STATES,
                                                           load_torch_file)
from deepspeed_tpu_torch.runtime.compiled_step import CompiledStep
from deepspeed_tpu_torch.utils.logging import log_dist, warning_once

_DTYPES = {None: None, "fp16": torch.float16, "float16": torch.float16,
           "bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp32": torch.float32, "float32": torch.float32}


def prefill_chunk_spans(model_cfg, T: int):
    """Spans of an exact ring-cache prefill of a ``T``-token prompt (JAX
    :64-90).

    None when one pass is exact: a dense cache, or ``T <= ring_len`` from
    an empty cache (no key is evicted before every query of the pass has
    attended it). Otherwise block-aligned ``[(start, end), ...]`` spans of
    at most one layout block: a pass over layout blocks ``[b0, b1]`` needs
    blocks ``b0 - w_blk .. b1`` in the ring at once, and the ring holds
    ``w_blk + 1`` blocks, so ``b1 == b0``. The partial tail stays inside
    one block, so it is exact too."""
    ring = ring_engaged(model_cfg) if model_cfg is not None else None
    if ring is None:
        return None
    w_blk, g_tok, blk = ring
    ring_len = ring_storage_len(model_cfg, ring)
    if T <= ring_len:
        return None
    return [(s, min(s + blk, T)) for s in range(0, T, blk)]


def continuation_chunk_spans(model_cfg, start: int, end: int):
    """Spans of an exact continuation prefill of columns ``[start, end)``
    on a cache that already holds ``start`` positions (JAX :92-125): a
    prefix-cache admission resumes mid-prompt, at any ``start``. A pass
    writing ``[s, e)`` evicts up to ``e - ring_len`` while its first query
    needs block ``s // blk - w_blk``: exact when the span stays inside one
    layout block. When ``end <= ring_len`` nothing is evicted and one pass
    is exact; a dense cache is always one pass."""
    if not 0 <= start < end:
        raise ValueError(f"bad continuation span [{start}, {end})")
    ring = ring_engaged(model_cfg) if model_cfg is not None else None
    if ring is not None:
        w_blk, g_tok, blk = ring
        ring_len = ring_storage_len(model_cfg, ring)
        if end > ring_len:
            return [(s, min(end, (s // blk + 1) * blk))
                    for s in range(start, end)
                    if s == start or s % blk == 0]
    return [(start, end)]


def init_inference(model, config: Optional[Dict[str, Any]] = None,
                   mp_size: int = 1, dtype=None, checkpoint: Optional[str] = None,
                   replace_with_kernel_inject: bool = True, seed: int = 0,
                   ep_size: int = 1, *, device=None, state_dict=None):
    """Build an InferenceEngine (``deepspeed_tpu.init_inference``'s
    signature, plus where to run and, optionally, the weights).

    ``device``: None means ``"cuda"``. ``state_dict``: weights for the model
    (e.g. from ``module_inject.jax_params.gpt_state_dict_from_jax``);
    ``checkpoint``: a path the weights are loaded from instead (see the
    module docstring); with neither, they are drawn at random from
    ``seed``. The weights are taken in the engine's dtype.
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


def load_checkpoint_weights(path: str):
    """The model ``state_dict`` at ``path``: a file saved by
    ``save_checkpoint`` (model states) or ``save_16bit_model``, or a tag
    directory, whose model-states file must match its manifest entry (the
    optimizer's files, ~80% of a tag, are not read). A mixture of experts'
    tag keeps its experts in one file per expert beside the model-states
    file (``runtime/moe_checkpoint.py``): they are merged back, each
    checked against the manifest too. Host tensors mapped from the
    files."""
    manifest = None
    if os.path.isdir(path):
        manifest = ckpt_manifest.read_manifest(path)
        path = os.path.join(path, MODEL_STATES)

    def load(file):
        if manifest is not None:
            name = os.path.basename(file)
            want = manifest["files"].get(name)
            got = ckpt_manifest.file_digest(file)
            if got != want:
                raise RuntimeError(f"checkpoint {file} failed verification: "
                                   f"{got} on disk, manifest says {want}")
        return load_torch_file(file)

    state = moe_ckpt.load_with_experts(load, os.path.dirname(path),
                                       os.path.basename(path), "model")
    return state.get("module", state)


class InferenceEngine:
    # batch sizes whose KV cache and decode graphs are kept
    MAX_BATCH_SIZES = 4

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
                ("expert parallelism (ep_size > 1, ROADMAP A.9)",
                 ep_size != 1),
                ("dtype='int8'", config.get("dtype") == "int8"),
                ("the int8 KV cache ('kv_cache')",
                 config.get("kv_cache") is not None)):
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
        self.decode_chunk = max(1, int(config.get("decode_chunk", 32)))
        # the sampling temperature, a device scalar the decode graphs read
        self._temperature = torch.ones((), dtype=torch.float32,
                                       device=self.device)
        # batch size -> (KV cache, its decode runs), least recently used first
        self._decoders = collections.OrderedDict()
        if config.get("checkpoint"):
            if state_dict is not None:
                raise ValueError("pass checkpoint or state_dict, not both")
            state_dict = load_checkpoint_weights(config["checkpoint"])
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

    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, attention_mask=None):
        """Greedy (``temperature == 0``) or sampled generation; returns
        ``[B, max_new_tokens]`` token ids.

        Ragged batches pass ``attention_mask`` (1 = real token); prompts are
        LEFT-aligned here so that real tokens sit contiguously in the cache,
        as in the JAX engine."""
        return self._generate(input_ids, max_new_tokens, temperature,
                              attention_mask)

    @torch.inference_mode()
    def _generate(self, input_ids, max_new_tokens, temperature,
                  attention_mask, eager: bool = False):
        """``generate``; with ``eager`` the decode runs are called
        uncaptured on the card too (a reference for the decode graphs)."""
        cfg = self.module.config
        # one ring decision per call (JAX :565-590): the dense-decode
        # warning and the streaming exemption below read it; the cache
        # made for this batch size consults the same function
        ring = ring_engaged(cfg)
        if cfg.sparse_attention is not None and ring is None:
            warning_once(
                "generate() on a sparse_attention-configured model: "
                "this layout decodes with DENSE attention (training "
                "was block-sparse); window/longformer layouts decode "
                "sparse-exactly via the ring KV cache — including "
                "prompts longer than the ring, which prefill in "
                "block-aligned chunks — see docs/DIVERGENCES.md")
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
        # a ring-cached model without a position table streams past
        # n_positions (JAX :612-630): the ring evicts old window blocks and
        # keeps the globals; a position table keeps the cap
        streaming = ring is not None and not cfg.learned_positions
        if ids.shape[1] + max_new_tokens > cfg.n_positions and not streaming:
            raise ValueError(
                f"prompt ({ids.shape[1]}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the KV cache capacity (n_positions={cfg.n_positions})")
        if attention_mask is None:
            attention_mask = torch.ones(ids.shape, dtype=torch.bool,
                                        device=self.device)

        cache, decode = self._decoder(ids.shape[0])
        logits = self._chunked_prefill(ids, attention_mask, cache.reset())
        sampled = temperature > 0
        if sampled:
            self._temperature.fill_(temperature)
        tok = self._next_token(logits[:, -1], sampled)
        out = [tok[:, None]]
        chunk = self.decode_chunk
        if chunk & (chunk - 1):
            warning_once(
                f"decode_chunk={chunk} is not a power of two; dispatches "
                f"use {1 << (chunk.bit_length() - 1)}-token runs (plus a "
                "binary-decomposed tail)")
        remaining = max_new_tokens - 1
        while remaining > 0:
            # the largest power of two <= min(chunk, remaining)
            k = 1 << (min(chunk, remaining).bit_length() - 1)
            toks = self._decode_run(decode, cache, tok, k, sampled, eager)
            out.append(toks)
            tok = toks[:, -1]
            remaining -= k
        return torch.cat(out, dim=1)

    def _chunked_prefill(self, ids, attention_mask, cache: KVCache):
        """Prefill ``ids`` into ``cache`` exactly (JAX :533-550): one pass
        when that is exact, else block-aligned passes of at most one layout
        block (``prefill_chunk_spans``). Returns the last pass's logits;
        with left-padded prompts its last column is every row's last real
        token. ``attention_mask`` [B, T] is required (``generate`` makes
        one of ones when it is given none)."""
        spans = prefill_chunk_spans(self.module.config, int(ids.shape[1]))
        for s, e in spans or [(0, ids.shape[1])]:
            logits, _ = self.module(ids[:, s:e],
                                    attention_mask=attention_mask[:, s:e],
                                    decode=True, cache=cache)
        return logits

    def _decoder(self, batch: int):
        """The KV cache (dense, or the ring of a window layout) and the
        decode runs kept for ``batch``."""
        entry = self._decoders.get(batch)
        if entry is None:
            cache = kv_cache(self.module.config, batch, self.device)
            gens = (self._generator,) if self.device.type == "cuda" else ()
            runs = CompiledStep(
                functools.partial(self._decode_steps, cache), self.device,
                warmup=1, max_graphs=2 * self.decode_chunk.bit_length(),
                generators=gens)
            entry = self._decoders[batch] = (cache, runs)
            while len(self._decoders) > self.MAX_BATCH_SIZES:
                _, (_, old) = self._decoders.popitem(last=False)
                for graph in old.graphs.values():
                    graph.graph.reset()
        else:
            self._decoders.move_to_end(batch)
        return entry

    def _decode_run(self, decode: CompiledStep, cache: KVCache, tok, k: int,
                    sampled: bool, eager: bool = False):
        """``k`` decode steps after ``tok`` ([B]): their tokens [B, k]. The
        cache's ``length`` is the host's, advanced here by k (a replay runs
        no Python)."""
        length = cache.length
        run = decode.eager if eager else decode
        toks = run({"tok": tok}, k, sampled)
        cache.length = length + k
        return toks

    def _decode_steps(self, cache: KVCache, k: int, sampled: bool, tok):
        """The step function of one run: ``k`` decode steps through the
        cache, each feeding its token to the next."""
        toks = []
        for _ in range(k):
            logits, _ = self.module(tok[:, None], decode=True, cache=cache)
            tok = self._next_token(logits[:, -1], sampled)
            toks.append(tok)
        return torch.stack(toks, dim=1)

    def _next_token(self, logits, sampled: bool):
        if sampled:
            probs = torch.softmax(logits / self._temperature, dim=-1)
            return torch.multinomial(probs, 1,
                                     generator=self._generator)[:, 0]
        # first index among equal maxima, as jnp.argmax
        return torch.argmax(logits, dim=-1)

    @property
    def params(self):
        return self.module.state_dict()
