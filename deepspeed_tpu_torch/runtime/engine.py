"""The training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``:
``initialize`` :81, ``DeepSpeedEngine`` with ``train_batch`` :2055, the
fused step ``_build_train_step`` :1379 and the split ``_build_fwd_bwd``
:1273 / ``_build_apply`` :1323).

One card. ``train_batch`` with ``gradient_accumulation_steps == 1`` is one
fused step that keeps no f32 accumulation buffer; with more, it runs
``forward`` (the micro step: forward, backward and the f32 accumulation of
``loss * scale / gas`` gradients, fused as in the JAX engine),
``backward`` (bookkeeping) and ``step`` (the update at the boundary). The
update follows the JAX step exactly: gradients to f32 and divided by the
loss scale, the global norm, the clip factor ``min(1, clip / (norm +
1e-6))``, each gradient cast to its parameter's dtype, the optimizer, the
fp16 overflow skip and the loss scale update.

Each of the three steps (fused, micro, apply) is a function of tensors
only, run by ``runtime/compiled_step.CompiledStep``: called directly on the
CPU, captured once per batch signature as a CUDA graph and replayed on the
card (the counterpart of the jitted step). The loss scale is device state
threaded through it, the fp16 skip is decided on the card, the optimizer
reads lr and its bias corrections from device buffers, and the clip bound is
a device scalar. Around each step the host writes the step's scalars
(``optimizer.prepare``) before and, after, reads the overflow flag once
(fp16 only), advances the counters and the lr schedule.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when torch sees no card. Pass ``device="cpu"`` to train on the host (the
kernels then take their plain PyTorch versions).
"""

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.models.bert import BertForPreTraining, materialize_bert
from deepspeed_tpu_torch.models.transformer_lm import GPT, materialize_gpt
from deepspeed_tpu_torch.runtime.compiled_step import CompiledStep
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.loss_scaler import (has_overflow,
                                                     init_loss_scale,
                                                     update_loss_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import (LRScheduler,
                                                      build_lr_scheduler,
                                                      schedule_fn_from_config)
from deepspeed_tpu_torch.runtime.optimizer import build_optimizer
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, get_global_norm
from deepspeed_tpu_torch.utils.logging import log_dist
from deepspeed_tpu_torch.utils.timer import ThroughputTimer


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config=None,
               config_params=None, seed: int = 0, *, device=None):
    """Build the engine; returns ``(engine, optimizer, dataloader,
    lr_scheduler)`` as ``deepspeed_tpu.initialize`` does.

    ``model`` is a ``GPT`` or a ``BertForPreTraining``, whose forward with
    ``labels`` returns the mean loss. A ``sparse_attention`` block in the
    config rebuilds the model with block-sparse attention, as the JAX engine
    does (a ``GPT`` refuses it: its sparse route is not ported yet).
    ``model_parameters`` is an initial ``state_dict`` (for example
    ``module_inject.jax_params.gpt_state_dict_from_jax`` of a flax tree),
    taken as the model's parameters and trained in place: the counterpart
    of the JAX package's initial parameter tree. Without it the weights are
    drawn from ``seed``. ``config`` is a dict or a JSON
    path (or ``config_params``, or ``args.deepspeed_config``)."""
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if config is None and config_params is not None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize: config is required")
    if optimizer is not None:
        raise NotImplementedError(
            "a client optimizer is not ported; configure the optimizer "
            "block of the config")
    engine = DeepSpeedEngine(model, config, lr_scheduler=lr_scheduler,
                             initial_state_dict=model_parameters, seed=seed,
                             device=device)
    dataloader = None
    if training_data is not None:
        dataloader = engine.deepspeed_io(training_data)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler


class DeepSpeedEngine:
    # graphs kept per step function (one per batch signature)
    MAX_GRAPHS = 4

    def __init__(self, model, config, lr_scheduler=None,
                 initial_state_dict=None, seed: int = 0, device=None):
        if not isinstance(model, (GPT, BertForPreTraining)):
            raise NotImplementedError(
                f"the port trains deepspeed_tpu_torch GPT and "
                f"BertForPreTraining models; {type(model).__name__} "
                "(PipelineModule included) is not ported")
        if not isinstance(config, DeepSpeedConfig):
            config = DeepSpeedConfig(config)
        config._resolve_batch_triad(1)  # one card
        unported = config.unported_features()
        if unported:
            raise NotImplementedError(
                f"config blocks not ported to deepspeed_tpu_torch yet: "
                f"{', '.join(unported)}")
        self._config = config
        if config.sparse_attention is not None:
            # block-sparse attention from the config alone, as
            # deepspeed_tpu/runtime/engine.py:267-277 applies it
            from deepspeed_tpu_torch.ops.sparse_attention.sparse_attention_utils \
                import apply_sparse_attention

            model = apply_sparse_attention(model, config.sparse_attention)
            log_dist(f"sparse attention enabled: "
                     f"{type(model.config.sparse_attention).__name__}",
                     ranks=[0])
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "initialize runs on a CUDA card by default and torch sees "
                    "none; pass device='cpu' to train on the host")
            device = "cuda"
        self.device = torch.device(device)

        self.module = model
        t0 = time.perf_counter()
        generator = torch.Generator(device=self.device).manual_seed(seed)
        materialize = (materialize_bert if isinstance(model, BertForPreTraining)
                       else materialize_gpt)
        materialize(model, self.device, generator, state_dict=initial_state_dict)
        model.train()
        self._params = list(model.parameters())
        for p in self._params:
            p.requires_grad_(True)

        self.fp16_enabled = config.fp16.enabled
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.train_micro_batch_size_per_gpu = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size
        self.gradient_clipping = config.gradient_clipping
        self.zero_stage = config.zero_config.stage

        self.lr_scheduler, schedule_fn = self._configure_lr(lr_scheduler)
        self.optimizer = build_optimizer(
            self._params, config.optimizer.type, config.optimizer.params,
            schedule_fn, use_pallas=config.tpu.use_pallas_optimizer)
        self._ls_state, self._ls_config = init_loss_scale(
            config.fp16, enabled=self.fp16_enabled, device=self.device)
        # device scalars, made once: the clip bound and, for the fp16 micro
        # step, the accumulation count
        self._max_norm = None
        if self.gradient_clipping and self.gradient_clipping > 0:
            self._max_norm = torch.tensor(float(self.gradient_clipping),
                                          dtype=torch.float32,
                                          device=self.device)
        self._gas = torch.tensor(float(self.gradient_accumulation_steps),
                                 dtype=torch.float32, device=self.device)

        # the steps, each captured per batch signature on a card; one memory
        # pool for the engine's graphs
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        self._fused = CompiledStep(self._fused_step, self.device,
                                   max_graphs=self.MAX_GRAPHS, pool=pool)
        self._micro = CompiledStep(self._micro_step, self.device,
                                   max_graphs=self.MAX_GRAPHS, pool=pool)
        self._apply = CompiledStep(self._apply_step, self.device, pool=pool)

        # forward/backward/step: f32 sums of the micro steps' grads
        # (allocated at the first micro step)
        self._acc_grads = None
        self._pending_loss = None
        self._last_grad_norm = None

        self.micro_steps = 0
        self.global_steps = 0
        self.skipped_steps = 0
        self.global_samples = 0
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size,
            steps_per_output=config.steps_per_print)
        n_params = sum(p.numel() for p in self._params)
        log_dist(
            f"DeepSpeedEngine: device={self.device}, {n_params / 1e6:.1f}M "
            f"params in {time.perf_counter() - t0:.1f}s, zero_stage="
            f"{self.zero_stage} (unsharded on one card), dtype="
            f"{config.precision_dtype}, micro_bs="
            f"{self.train_micro_batch_size_per_gpu}, gas="
            f"{self.gradient_accumulation_steps}, optimizer="
            f"{type(self.optimizer).__name__}", ranks=[0])

    # -- configuration ----------------------------------------------------
    def _configure_lr(self, lr_scheduler):
        cfg = self._config
        if lr_scheduler is None and cfg.scheduler.type is not None:
            return (build_lr_scheduler(cfg.scheduler.type, cfg.scheduler.params),
                    schedule_fn_from_config(cfg.scheduler.type,
                                            cfg.scheduler.params))
        if isinstance(lr_scheduler, LRScheduler):
            return lr_scheduler, lr_scheduler.schedule_fn
        if callable(lr_scheduler):
            return LRScheduler(lr_scheduler), lr_scheduler
        return None, None

    # -- data -------------------------------------------------------------
    def deepspeed_io(self, dataset, collate_fn=None, shuffle=True):
        return DeepSpeedDataLoader(
            dataset, batch_size=self.train_micro_batch_size_per_gpu,
            shuffle=shuffle, drop_last=self._config.dataloader_drop_last,
            collate_fn=collate_fn)

    def _put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """A dict of numpy arrays or tensors, on the engine's device; integer
        arrays become int64 (token ids, masks, segment ids, positions)."""
        out = {}
        for key, x in dict(batch).items():
            x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
            if not x.is_floating_point() and x.dtype != torch.bool:
                x = x.long()
            out[key] = x.to(self.device, non_blocking=True)
        return out

    # -- the step functions (tensors only: no host read) --------------------
    def _update(self, grads):
        """The update from gradients already divided by the loss scale
        (modified in place): the overflow flag (fp16 only), the global norm
        in f32, the clip, the cast to each parameter's dtype, the optimizer
        (skipped on the card on overflow) and the loss-scale update. Returns
        ``(norm, overflow)``, overflow None without fp16. ``grads`` are
        f32, or the parameters' own dtype when there was no scale to divide
        by: the norm accumulates in f32 and the clip multiply rounds once to
        the dtype either way, so both give the JAX step's values."""
        overflow = has_overflow(grads) if self.fp16_enabled else None
        if self._max_norm is not None:
            norm = clip_grad_norm_(grads, self._max_norm)
        else:
            norm = get_global_norm(grads)
        # g.astype(p.dtype): a new tensor only where the dtypes differ
        self.optimizer.apply([g.to(p.dtype) for g, p in zip(grads, self._params)],
                             skip=overflow)
        if self.fp16_enabled and self._ls_config.dynamic:
            self._ls_state.copy_(update_loss_scale(self._ls_state, overflow,
                                                   self._ls_config))
        return norm, overflow

    def _grads_of(self, loss_scaled):
        """Backward of ``loss_scaled``; returns the parameters' grads (in
        their dtype) and clears them from the parameters."""
        loss_scaled.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._params]
        for p in self._params:
            p.grad = None
        return grads

    def _fused_step(self, **batch):
        """gas == 1: gradients of ``loss * scale`` go straight to the update
        (no f32 accumulation buffer). Returns ``(loss, norm, overflow)``."""
        loss = self.module(**batch)
        if self.fp16_enabled:
            scale = self._ls_state.scale
            grads = [g.float() for g in self._grads_of(loss * scale)]
            torch._foreach_div_(grads, scale)
        else:
            grads = self._grads_of(loss)
        return (loss.detach(),) + self._update(grads)

    def _micro_step(self, **batch):
        """One micro batch: forward, backward of ``loss * scale / gas``, and
        the grads added in f32 to the accumulation buffers. Returns the
        loss."""
        loss = self.module(**batch)
        factor = (self._ls_state.scale / self._gas if self.fp16_enabled
                  else 1.0 / self.gradient_accumulation_steps)
        for acc, g in zip(self._acc_grads, self._grads_of(loss * factor)):
            acc.add_(g)
        return loss.detach()

    def _apply_step(self):
        """The boundary: the update from the f32 sums themselves (divided
        and clipped in place), then the sums set to 0. Returns ``(norm,
        overflow)``."""
        grads = list(self._acc_grads)
        if self.fp16_enabled:
            torch._foreach_div_(grads, self._ls_state.scale)
        out = self._update(grads)
        for acc in self._acc_grads:
            acc.zero_()
        return out

    # -- the host around them ----------------------------------------------
    def _finish_update(self, norm, overflow) -> bool:
        """After an update: the one host read of the overflow flag (fp16
        only), the optimizer's count, the last grad norm. Returns whether
        the step was skipped."""
        skipped = bool(overflow) if self.fp16_enabled else False
        self.optimizer.commit(not skipped)
        if not skipped:
            self._last_grad_norm = norm
        return skipped

    def _post_step(self, skipped):
        if skipped:
            self.skipped_steps += 1
            log_dist(f"overflow at step {self.global_steps}; loss scale -> "
                     f"{self.loss_scale}", ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.global_steps % self._config.steps_per_print == 0:
            scale = self.loss_scale if self.fp16_enabled else 1.0
            log_dist(f"step={self.global_steps}, skipped={self.skipped_steps}, "
                     f"lr={self.get_lr()}, loss_scale={scale}", ranks=[0])

    def train_batch(self, data_iter):
        """One optimizer step over ``gradient_accumulation_steps`` micro
        batches from ``data_iter``; returns the mean micro loss."""
        return self._train_batch(data_iter)

    def _train_batch(self, data_iter, eager: bool = False):
        """``train_batch``; with ``eager`` the step functions run
        uncaptured on the card too (a reference for the captured steps)."""
        if self.gradient_accumulation_steps == 1:
            return self._train_batch_fused(next(data_iter), eager)
        losses = []
        for _ in range(self.gradient_accumulation_steps):
            losses.append(self._forward(next(data_iter), eager))
            self.backward()
            self._step(eager)
        return torch.stack(losses).mean()

    @staticmethod
    def _run(step: CompiledStep, inputs, eager: bool):
        return step.eager(inputs) if eager else step(inputs)

    def _train_batch_fused(self, batch, eager=False):
        self.module.train()
        self.optimizer.prepare()
        loss, norm, overflow = self._run(self._fused, self._put_batch(batch),
                                         eager)
        skipped = self._finish_update(norm, overflow)
        self.micro_steps += 1
        self.global_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu
        self._post_step(skipped)
        self.tput_timer.stop(global_step=True)
        return loss

    def forward(self, batch: Dict[str, Any]):
        """The loss of one micro batch. Its gradients are computed with it
        (fused, as in the JAX engine) and added in f32 to the accumulation
        buffers; ``backward()`` then records the micro step."""
        return self._forward(batch, False)

    def _forward(self, batch, eager):
        self.module.train()
        if self._acc_grads is None:
            self._acc_grads = [torch.zeros_like(p, dtype=torch.float32)
                               for p in self._params]
        loss = self._run(self._micro, self._put_batch(batch), eager)
        self._pending_loss = loss
        return loss

    def backward(self, loss=None):
        """Records the last ``forward``'s micro step (its gradients are
        already accumulated); returns its loss."""
        if self._pending_loss is None:
            raise RuntimeError("backward() must follow forward()")
        loss, self._pending_loss = self._pending_loss, None
        return loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return (self.micro_steps + 1) % self.gradient_accumulation_steps == 0

    def step(self):
        """The optimizer step, at the accumulation boundary only."""
        self._step(False)

    def _step(self, eager):
        at_boundary = self.is_gradient_accumulation_boundary()
        if at_boundary:
            self.optimizer.prepare()
            norm, overflow = self._run(self._apply, {}, eager)
            skipped = self._finish_update(norm, overflow)
            self.global_steps += 1
            self._post_step(skipped)
        self.micro_steps += 1
        self.global_samples += self.train_micro_batch_size_per_gpu
        self.tput_timer.stop(global_step=at_boundary)

    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, Any]):
        """The loss (or logits, without labels) in eval mode."""
        self.module.eval()
        try:
            return self.module(**self._put_batch(batch))
        finally:
            self.module.train()

    __call__ = eval_batch

    # -- introspection ----------------------------------------------------
    def get_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        return [self._config.optimizer.params.get("lr", 0.0)]

    def get_global_grad_norm(self) -> Optional[float]:
        """Pre-clip global gradient norm of the last optimizer step."""
        return None if self._last_grad_norm is None else float(self._last_grad_norm)

    @property
    def loss_scale(self) -> float:
        """The current loss scale (a read of the device state)."""
        return float(self._ls_state.scale)

    @property
    def params(self):
        return self.module.state_dict()

    def set_lr(self, lr: float):
        raise NotImplementedError(
            "set_lr (param_groups['lr'] write-through) is not ported yet")

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "checkpoint save is not ported yet (the JAX format is flax "
            "serialization and needs a design of its own)")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            "checkpoint load is not ported yet (the JAX format is flax "
            "serialization and needs a design of its own)")
