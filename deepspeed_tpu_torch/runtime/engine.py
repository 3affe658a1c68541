"""The training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``:
``initialize`` :81, ``DeepSpeedEngine`` with ``train_batch`` :2055, the
fused step ``_build_train_step`` :1379 and the split ``_build_fwd_bwd``
:1273 / ``_build_apply`` :1323).

``train_batch`` with ``gradient_accumulation_steps == 1`` is one
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

Checkpoints (``save_checkpoint`` :2580, ``load_checkpoint`` :2749 of the
JAX engine, the dense one-card branch): a tag directory holds
``mp_rank_00_model_states.pt`` (the model ``state_dict``),
``engine_states.pt`` (counters, the lr scheduler's and the dataloader's
state, ``client_state``) and ``zero_pp_rank_0_mp_rank_00_optim_states.pt``
(the optimizer's ``state_dict`` by parameter name and the loss-scale
state), written by the checkpoint engine (``runtime/checkpoint_engine.py``)
and certified by a manifest in the JAX package's schema. A load restores
every tensor with ``copy_`` into the storage it already has, so the captured
graphs and B4's pointer table stay valid and no step is captured again.

Data parallelism and ZeRO stages 0-3 (JAX engine :297-354 for the
topology and the sharding rules, :1459-1470 and :1514-1545 for the
data). Without an initialised
process group the engine is the one-card engine above. With one
(``comm.init_distributed``; world 1 included), the mesh comes from the
config over the group's ranks (``tpu.mesh``: dp and fsdp; a ZeRO stage
moves dp to fsdp), the batch triad resolves at the data-parallel size,
and ``runtime/zero/stage_1_and_2.ZeroOptimizer`` owns the flat parameter,
gradient and optimizer-state buffers and their exchanges; the step
functions are the same three, with the exchange inside them, so a card
captures the collectives in the step's graph. Each rank weights its mean
loss by its share of the global batch's loss weights (one all-reduce of
the weight sum before the backward), so the summed gradient is the global
mean's gradient even when the ranks' label counts differ, and
``train_batch`` returns the global mean loss on every rank.
``deepspeed_io`` loads the global micro batch, ``micro x dp`` rows, and
``_put_batch`` keeps the rank's rows. Rank 0's parameters are broadcast
at ``initialize``. At stage 3 (a ``GPT`` or a ``BertForPreTraining``; not
a mixture of experts) ``runtime/zero/stage3.ZeroStage3Optimizer`` partitions the parameters by
unit: the step calls the model through it (``_model``), each unit's
gather and reduce-scatter run inside the forward and the backward, so the
backward's gradients arrive reduce-scattered and only the whole leaves
under the threshold are collected and exchanged as at stage 2; the
module's partitioned parameters are placeholders, and ``params`` gathers
them. A checkpoint is the same tag at every world: rank 0 writes the
whole tensors (gathering the optimizer's shards one parameter at a time,
and at stage 3 the parameters unit by unit), every rank loads its slice,
and a load at another world or stage reshards (``runtime/reshard.py``).

The explicit gradient exchanges (JAX engine :298-340, :1036-1252): with
``tpu.grad_exchange.deferred`` on a dp axis of several ranks,
``communication_data_type: "int8"`` or a 1-bit optimizer, at ZeRO stage 0
(stage 1 for the 1-bit family, its state replicated, dp kept on dp),
``runtime/compressed_exchange.CompressedExchange`` takes ZeRO's place:
each rank keeps the gradient of its own mean loss as an f32 sum in the JAX
engine's flat layout through the accumulation window, and the ranks
exchange once at the boundary, inside the captured step; the loss is the
mean of the ranks' losses. The 1-bit optimizers' branch (warm-up or
compressed, 0/1 Adam's variance refresh) is a static key of the step, so
each has its own graph.

The data path (JAX engine :1455-1545, :2044-2053): with the
``data_pipeline`` block ``deepspeed_io`` builds ``data/``'s packed pipeline
(sharded by the data-parallel rank under ``shard: "process"``), behind a
prefetcher whose worker copies each batch to the card on a stream of its
own (``_prefetch_put``); ``_put_batch`` takes such a batch as it is once
the step's stream has waited for its copies. ``curriculum_learning``
truncates each batch to the scheduled length before the step, and under
``curriculum_pack`` the pipeline packs to it (``_PackingLength``). A
checkpoint holds every rank's loader state.

Mixture of experts (JAX engine :1173, :1295, :1399: a ``gating`` key,
``fold_in(rng, 7)``, in every training step): the engine owns one
generator on its device, seeded from ``seed``, and each step function draws
every MoE layer's gating noise from it before the forward, into a buffer
kept per token count, and hands it to the model. Drawn up front, the noise
is what the full-remat recompute sees too (``torch.utils.checkpoint`` would
restore only the default generators' states); the generator is registered
with every captured step, so each replay draws afresh, as an uncaptured
step from the same state would, bit for bit; a checkpoint holds its state,
so a resume draws what an unbroken run would. The expert leaves are plain
parameters at ZeRO 0-2 (one card: ``ep`` is ROADMAP A.9), and a tag splits
them and their moments into one file per expert
(``runtime/moe_checkpoint.py``).

Dropout and stochastic depth (JAX engine :1284-1298: a ``dropout`` key
per step, ``pld_theta`` from ``_pld_model_kwargs`` :1257-1271): a GPT or a BERT
with ``dropout > 0`` or ``stochastic_mode`` gets a second generator on the
engine's device (``_dropout_gen``), handed to the model with each training
forward; like the gating generator it is registered with every captured
step and saved in a tag. Under data parallelism each rank draws every
mask over the global micro batch and keeps its rows
(``activation_checkpointing.GlobalBatchDraws``), so a dp run draws the
masks of the one-rank run at the global micro batch, row for row. Under ``progressive_layer_drop`` the engine keeps
the global step in a device counter (``_pld_step``, advanced inside the
step functions) and computes ``pld_theta`` from it in the step, so a replay
needs no host write; the host schedule (``progressive_layer_drop``) is
updated after each step, as in JAX. ``activation_checkpointing`` and
``tpu.remat`` configure ``runtime/activation_checkpointing``'s module-level
policy (JAX engine :541-546).

Entry points run on the card: ``device=None`` means ``"cuda"`` (under a
NCCL group ``cuda:{local_rank}``, one card per rank) and raises when torch
sees no card. Pass ``device="cpu"`` to train on the host (the kernels then
take their plain PyTorch versions; a group must then be gloo).
"""

import dataclasses
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm.logging import comms_logger
from deepspeed_tpu_torch.data import DevicePrefetcher, PackedDataPipeline
from deepspeed_tpu_torch.data.prefetch import CopyStream, PlacedBatch
from deepspeed_tpu_torch.models.bert import BertForPreTraining, materialize_bert
from deepspeed_tpu_torch.models.transformer_lm import GPT, materialize_gpt
from deepspeed_tpu_torch.moe.layer import draw_gating_noise
from deepspeed_tpu_torch.parallel.mesh import (MeshTopology,
                                               set_default_topology)
from deepspeed_tpu_torch.runtime import activation_checkpointing
from deepspeed_tpu_torch.runtime.activation_checkpointing import \
    GlobalBatchDraws
from deepspeed_tpu_torch.runtime import checkpoint_manifest as ckpt_manifest
from deepspeed_tpu_torch.runtime import layout
from deepspeed_tpu_torch.runtime import moe_checkpoint as moe_ckpt
from deepspeed_tpu_torch.runtime import reshard
from deepspeed_tpu_torch.runtime.checkpoint_engine import (
    ENGINE_STATES, MODEL_STATES, OPTIM_STATES, select_checkpoint_engine,
    write_torch_file)
from deepspeed_tpu_torch.runtime.compiled_step import CompiledStep
from deepspeed_tpu_torch.runtime.compressed_exchange import (
    CompressedExchange, select_mode, validate_compressed_config)
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfig
from deepspeed_tpu_torch.runtime.data_pipeline import (
    CurriculumScheduler, truncate_batch_to_difficulty)
from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader
from deepspeed_tpu_torch.runtime.loss_scaler import (LossScaleState,
                                                     has_overflow,
                                                     init_loss_scale,
                                                     update_loss_scale)
from deepspeed_tpu_torch.runtime.lr_schedules import (LRScheduler,
                                                      build_lr_scheduler,
                                                      schedule_fn_from_config)
from deepspeed_tpu_torch.runtime.optimizer import build_optimizer
from deepspeed_tpu_torch.runtime.progressive_layer_drop import \
    ProgressiveLayerDrop
from deepspeed_tpu_torch.runtime.utils import clip_grad_norm_, get_global_norm
from deepspeed_tpu_torch.runtime.zero.stage3 import ZeroStage3Optimizer
from deepspeed_tpu_torch.runtime.zero.stage_1_and_2 import (DATA_AXES,
                                                            ZeroOptimizer)
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (SynchronizedWallClockTimer,
                                             ThroughputTimer)

# the gating generator's seed is the engine's seed plus this (the JAX
# engine folds 7 into each step's key for its "gating" stream)
GATING_SEED_OFFSET = 7
# the dropout generator's seed is the engine's seed plus this (the JAX
# engine's dropout key is fold_in(rng, 1) at init, :804)
DROPOUT_SEED_OFFSET = 1

FORWARD_MICRO_TIMER = "fwd_bwd_microstep"
STEP_MICRO_TIMER = "step_microstep"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config=None,
               config_params=None, seed: int = 0, *, device=None):
    """Build the engine; returns ``(engine, optimizer, dataloader,
    lr_scheduler)`` as ``deepspeed_tpu.initialize`` does: ``optimizer`` is
    the engine's ``OptimizerAdapter`` (``param_groups``, with ``lr``
    written through ``set_lr``), ``dataloader`` the engine's
    ``training_dataloader`` when ``training_data`` is given.

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
    return engine, engine.optimizer_adapter, dataloader, engine.lr_scheduler


class _ParamGroup(dict):
    """One param group with torch-optim write-through (the JAX engine's
    ``_ParamGroup``): assigning ``lr`` calls ``engine.set_lr``; the other
    hyperparameters are fixed in the optimizer, and a write to them
    raises."""

    _FIXED_KEYS = ("betas", "eps", "weight_decay", "momentum", "params")

    def __init__(self, engine, data):
        super().__init__(data)
        self._engine = engine

    def __setitem__(self, key, value):
        if key == "lr":
            self._engine.set_lr(value)  # raises before the view changes
        elif key in self._FIXED_KEYS:
            raise NotImplementedError(
                f"param_groups[{key!r}] is fixed in the optimizer; only "
                "'lr' writes through (build a new engine to change it)")
        super().__setitem__(key, value)


class OptimizerAdapter:
    """The torch-optim surface ``initialize`` returns (the JAX engine's
    ``OptimizerAdapter``): one param group with the optimizer family's own
    hyperparameters (no Adam keys on SGD), and the state by name."""

    def __init__(self, engine: "DeepSpeedEngine"):
        self._engine = engine

    @property
    def state(self):
        return self._engine.optimizer.state_dict()["state"]

    @property
    def param_groups(self):
        eng = self._engine
        opt_p = dict(eng._config.optimizer.params or {})
        group = {"lr": eng.get_lr()[0], "params": list(eng._params)}
        name = (eng._config.optimizer.type or "adamw").lower()
        if "adam" in name or "lamb" in name:
            betas = opt_p.get("betas", (0.9, 0.999))
            group["betas"] = (float(betas[0]), float(betas[1]))
            group["eps"] = float(opt_p.get("eps", 1e-8))
            group["weight_decay"] = float(opt_p.get("weight_decay", 0.0))
        elif "adagrad" in name:
            group["eps"] = float(opt_p.get("eps", 1e-10))
        elif "sgd" in name:
            group["momentum"] = float(opt_p.get("momentum", 0.0))
            group["weight_decay"] = float(opt_p.get("weight_decay", 0.0))
        return [_ParamGroup(eng, group)]

    def state_dict(self):
        return self._engine.optimizer.state_dict()


class _PackingLength:
    """The sequence length the packed pipeline packs its next batch to under
    ``curriculum_pack`` (the pipeline calls it once per batch). The JAX
    engine passes ``lambda: sched.current_difficulty``; without prefetch,
    batch n > 0 is drawn just after micro batch n - 1 set the difficulty of
    its step to ``get_difficulty((n - 1) // gas + 1)``, and batch 0 sees the
    difficulty the scheduler starts from. This returns exactly that, from
    n, so that a prefetch worker running ahead of the steps packs every
    batch to the length it has without prefetch, whatever the two threads'
    timing (the JAX prefetcher reads the difficulty of the moment, and the
    queue's depth decides how stale), and a resumed run packs the batches
    of the run it resumes (a fresh JAX engine packs its first batch after a
    resume at the starting difficulty). Under a monotone schedule the
    consumer's truncation then leaves every batch as it was packed."""

    def __init__(self, scheduler, gas, micro_steps):
        self.scheduler, self.gas = scheduler, gas
        self.initial = scheduler.current_difficulty
        self.restart(micro_steps)

    def restart(self, micro_steps):
        """Batch ``micro_steps`` is drawn next."""
        self.next_batch = micro_steps

    def __call__(self) -> int:
        n, self.next_batch = self.next_batch, self.next_batch + 1
        if n == 0:
            return self.initial
        return self.scheduler.get_difficulty((n - 1) // self.gas + 1)


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
        self._distributed = comm.is_initialized()
        # a compressed gradient exchange is checked first, with the JAX
        # engine's words (runtime/compressed_exchange.py)
        self._cx_mode = self._select_exchange(config, model)
        unported = config.unported_features()
        if unported:
            raise NotImplementedError(
                f"config blocks not ported to deepspeed_tpu_torch yet: "
                f"{', '.join(unported)}")
        if (self._distributed and config.zero_config.stage >= 3
                and isinstance(model, GPT) and model.config.is_moe):
            raise NotImplementedError(
                "ZeRO stage 3 of a mixture-of-experts GPT is not ported yet "
                "(ROADMAP A.3, what is left: the expert leaves in stage 3's "
                "per-block units); stages 0-2 take them as replicated "
                "parameters")
        self.topology = self._build_topology(config)
        config._resolve_batch_triad(self.topology.data_parallel_size)
        comms_logger.configure(config.comms_logger)
        self._config = config
        # module-level activation checkpointing (JAX engine :541-546):
        # models that call activation_checkpointing.checkpoint() take this
        # policy
        activation_checkpointing.configure(config, remat=config.tpu.remat)
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
            device = (f"cuda:{comm.get_local_rank()}" if self._distributed
                      else "cuda")
        self.device = torch.device(device)
        if self._distributed and (comm.get_backend() == "nccl") != (
                self.device.type == "cuda"):
            raise ValueError(
                f"a {comm.get_backend()} process group with the engine on "
                f"{self.device}: NCCL takes CUDA cards, gloo the CPU")

        self.module = model
        t0 = time.perf_counter()
        generator = torch.Generator(device=self.device).manual_seed(seed)
        materialize = (materialize_bert if isinstance(model, BertForPreTraining)
                       else materialize_gpt)
        materialize(model, self.device, generator, state_dict=initial_state_dict)
        model.train()
        # the gating noise's draws per MoE layer (none for a dense model),
        # and the generator they come from
        self._gating_kinds = ()
        if isinstance(model, GPT) and model.config.is_moe:
            self._gating_kinds = model.h[0].mlp.noise_kinds()
        self._gating_gen = None
        if self._gating_kinds:
            self._gating_gen = torch.Generator(device=self.device).manual_seed(
                seed + GATING_SEED_OFFSET)
        self._gating_noise = {}
        # the dropout masks' and the stochastic-depth gates' generator
        self._dropout_gen = None
        if model.config.dropout > 0 or model.config.stochastic_mode:
            self._dropout_gen = torch.Generator(
                device=self.device).manual_seed(seed + DROPOUT_SEED_OFFSET)
        # progressive layer drop (JAX engine :556-562): the host schedule,
        # and the global step on the device, from which each step computes
        # pld_theta
        self.progressive_layer_drop = None
        self._pld_step = None
        if config.progressive_layer_drop.enabled:
            pld = config.progressive_layer_drop
            self.progressive_layer_drop = ProgressiveLayerDrop(
                theta=pld.theta, gamma=pld.gamma)
            self._pld_step = torch.zeros((), dtype=torch.float32,
                                         device=self.device)
        named = list(model.named_parameters())
        self._params = [p for _, p in named]
        for p in self._params:
            p.requires_grad_(True)
        n_params = sum(p.numel() for p in self._params)

        self.fp16_enabled = config.fp16.enabled
        self.gradient_accumulation_steps = config.gradient_accumulation_steps
        self.train_micro_batch_size_per_gpu = config.train_micro_batch_size_per_gpu
        self.train_batch_size = config.train_batch_size
        self.gradient_clipping = config.gradient_clipping
        self.zero_stage = config.zero_config.stage
        self.data_parallel_size = self.topology.data_parallel_size

        self.lr_scheduler, schedule_fn = self._configure_lr(lr_scheduler)

        def build(params, names, runs=None, reduce=None, **kw):
            return build_optimizer(
                params, config.optimizer.type, config.optimizer.params,
                schedule_fn, use_pallas=config.tpu.use_pallas_optimizer,
                names=names, runs=runs, reduce=reduce, **kw)

        # device scalars, made once: the clip bound and, for the fp16 micro
        # step, the accumulation count
        self._max_norm = None
        if self.gradient_clipping and self.gradient_clipping > 0:
            self._max_norm = torch.tensor(float(self.gradient_clipping),
                                          dtype=torch.float32,
                                          device=self.device)
        self._gas = torch.tensor(float(self.gradient_accumulation_steps),
                                 dtype=torch.float32, device=self.device)

        # the data-parallel state (None on the one-card engine): ZeRO's, or
        # a compressed gradient exchange's
        self._zero = None
        self._cx = None
        if self._cx_mode is not None:
            self._cx = CompressedExchange(self._cx_mode, model, named, config,
                                          self.topology, build,
                                          self._max_norm)
            # every group and sub-group the step uses, before any capture
            comm.warm_up(["dp"], self.device, self._cx.index_groups())
            self.optimizer = self._cx.inner
        elif self._distributed:
            # NCCL makes a communicator at a group's first collective,
            # which must come before any capture
            comm.warm_up(self._exchange_axes(), self.device)
            rules = layout.build_sharding_rules(
                self.topology, self.zero_stage,
                config.zero_config.param_persistence_threshold)
            if self.zero_stage >= 3:
                self._zero = ZeroStage3Optimizer(
                    model, rules, build, comm_dtype=config.communication_dtype)
            else:
                self._zero = ZeroOptimizer(
                    named, rules, build, comm_dtype=config.communication_dtype)
            self.optimizer = self._zero
        else:
            self.optimizer = build(self._params, [name for name, _ in named])
        self.optimizer_adapter = OptimizerAdapter(self)
        # set_lr's absolute lr for the next step(s), None without one
        self._lr_override = None
        self.checkpoint_engine = select_checkpoint_engine(config)
        self.training_dataloader = None
        # the data path (deepspeed_io): the rows a loader's batch holds when
        # each rank packs its own (shard "process" over several ranks), the
        # prefetch worker's copies, and the curriculum's packing length
        self._local_rows = False
        self._copy_stream = None
        self._packing_length = None
        # curriculum learning (JAX engine :548-555): batches truncated to
        # the scheduled difficulty at consume time
        self.curriculum_scheduler = (
            CurriculumScheduler(config.curriculum_learning)
            if config.curriculum_learning.enabled else None)
        self._ls_state, self._ls_config = init_loss_scale(
            config.fp16, enabled=self.fp16_enabled, device=self.device)

        # the steps, each captured per batch signature on a card; one memory
        # pool for the engine's graphs
        pool = (torch.cuda.graph_pool_handle()
                if self.device.type == "cuda" else None)
        gens = (() if self.device.type != "cuda" else tuple(
            g for g in (self._gating_gen, self._dropout_gen) if g is not None))
        self._fused = CompiledStep(self._fused_step, self.device,
                                   max_graphs=self.MAX_GRAPHS, pool=pool,
                                   generators=gens)
        self._micro = CompiledStep(self._micro_step, self.device,
                                   max_graphs=self.MAX_GRAPHS, pool=pool,
                                   generators=gens)
        self._apply = CompiledStep(self._apply_step, self.device, pool=pool)

        # forward/backward/step: f32 sums of the micro steps' grads
        # (allocated at the first micro step)
        self._acc_grads = None
        self._pending_loss = None
        self._last_grad_norm = None
        # the last load_checkpoint's reshard decision (reshard.decide)
        self.last_reshard = None

        self.micro_steps = 0
        self.global_steps = 0
        self.skipped_steps = 0
        self.global_samples = 0
        self.tput_timer = ThroughputTimer(
            batch_size=self.train_batch_size,
            steps_per_output=config.steps_per_print)
        self.wall_clock_breakdown = bool(config.wall_clock_breakdown)
        self.timers = SynchronizedWallClockTimer()
        layout_note = (
            f"{self.topology}, {self._cx_mode} gradient exchange"
            if self._cx is not None else
            "one card, no process group" if self._zero is None
            else f"{self.topology}, " + (
                           "replicated" if not self._zero.sharded else
                           "parameters partitioned over fsdp by unit"
                           if self._stage3 else
                           "optimizer state partitioned over fsdp"))
        log_dist(
            f"DeepSpeedEngine: device={self.device}, {n_params / 1e6:.1f}M "
            f"params in {time.perf_counter() - t0:.1f}s, zero_stage="
            f"{self.zero_stage} ({layout_note}), dtype="
            f"{config.precision_dtype}, micro_bs="
            f"{self.train_micro_batch_size_per_gpu}, gas="
            f"{self.gradient_accumulation_steps}, optimizer="
            f"{type(self.optimizer).__name__}", ranks=[0])

    # -- configuration ----------------------------------------------------
    def _select_exchange(self, config, model) -> Optional[str]:
        """The compressed gradient exchange's mode (None: ZeRO's exchange or
        the one-card engine), validated as the JAX engine validates it on
        the mesh before ZeRO's move of dp to fsdp. The mode runs over a
        process group, in the JAX layout of the model's parameter tree (a
        GPT's or a BERT's)."""
        if not self._distributed:
            mode = select_mode(config, dp_size=1)
            if mode is not None:
                raise ValueError(
                    f"the {mode} gradient exchange runs over a process "
                    "group: call deepspeed_tpu_torch.comm.init_distributed "
                    "in every rank's process before initialize (one rank "
                    "is enough)")
            return None
        topology = layout.build_topology(config, comm.get_world_size())
        mode = select_mode(config, topology.size("dp"))
        if mode is None:
            return None
        validate_compressed_config(mode, config, topology)
        return mode

    def _build_topology(self, config) -> MeshTopology:
        """The one-card mesh without a process group (a mesh of more than
        one rank then raises); with one, the config's mesh over its ranks,
        dp moved to fsdp under ZeRO, and registered as the default topology
        (what the collectives' axis names resolve against)."""
        if not self._distributed:
            mesh = config.tpu.mesh_config
            if mesh.dp not in (1, -1) or mesh.fsdp != 1:
                raise ValueError(
                    f"tpu.mesh asks for dp={mesh.dp}, fsdp={mesh.fsdp} but no "
                    f"process group is initialised: call "
                    f"deepspeed_tpu_torch.comm.init_distributed in every "
                    f"rank's process before initialize")
            return MeshTopology(world_size=1)
        topology = layout.build_topology(config,
                                         world_size=comm.get_world_size())
        topology = layout.apply_zero_fsdp_move(
            topology, config.zero_config.stage,
            compressed=self._cx_mode is not None)
        set_default_topology(topology)
        return topology

    def _exchange_axes(self):
        """The mesh axes whose groups the step's collectives use (at stage 3
        the gathers and reduce-scatters run over fsdp too)."""
        axes = [DATA_AXES]
        if self.zero_stage >= 1:
            axes.append("fsdp")
            if self.topology.size("dp") > 1:
                axes.append("dp")
        return axes

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
        """The training loader, kept as ``training_dataloader`` (a
        checkpoint carries its state; JAX engine :1455-1478). Without the
        ``data_pipeline`` block: a ``DeepSpeedDataLoader`` of global micro
        batches (``micro x dp`` rows; every rank reads the same batch and
        keeps its rows). With it: the packed pipeline
        (``_build_data_pipeline``). A prefetcher an earlier call made is
        stopped."""
        self._stop_prefetch()
        if self._config.data_pipeline.enabled:
            loader = self._build_data_pipeline(dataset, shuffle)
        else:
            self._local_rows = False
            loader = DeepSpeedDataLoader(
                dataset, batch_size=(self.train_micro_batch_size_per_gpu
                                     * self.data_parallel_size),
                shuffle=shuffle, drop_last=self._config.dataloader_drop_last,
                collate_fn=collate_fn)
        self.training_dataloader = loader
        return loader

    def _build_data_pipeline(self, dataset, shuffle):
        """``PackedDataPipeline`` over ``dataset`` (documents: token
        sequences, or dicts with ``input_ids``), wrapped in a
        ``DevicePrefetcher`` whose worker runs ``_prefetch_put`` when
        ``prefetch`` is on (JAX engine :1480-1513).

        The JAX engine runs one process per host and shards the stream by
        process; the port runs one process per card, so the shard is the
        data-parallel rank. ``shard: "process"``: each rank packs its own
        ``micro`` rows from its own stride of the stream, and ``_put_batch``
        keeps them all. ``shard: "none"``: every rank packs the same global
        micro batch (``micro x dp`` rows, the JAX single-process run row
        for row) and keeps its slice. Under ``curriculum_pack`` the pipeline
        packs each batch to ``_PackingLength``'s length."""
        dp_cfg = self._config.data_pipeline
        micro, dp = self.train_micro_batch_size_per_gpu, self.data_parallel_size
        if dp_cfg.shard == "process":
            shard_rank, num_shards, rows = (
                self.topology.data_parallel_rank(), dp, micro)
        else:
            shard_rank, num_shards, rows = 0, 1, micro * dp
        self._local_rows = rows != micro * dp
        self._packing_length = None
        if dp_cfg.curriculum_pack and self.curriculum_scheduler is not None:
            self._packing_length = _PackingLength(
                self.curriculum_scheduler, self.gradient_accumulation_steps,
                self.micro_steps)
        pipeline = PackedDataPipeline(
            dataset, batch_size=rows, seq_length=dp_cfg.seq_length,
            pack_sequences=dp_cfg.pack_sequences,
            pad_token_id=dp_cfg.pad_token_id,
            shuffle=shuffle and dp_cfg.shuffle, seed=dp_cfg.seed,
            shard_rank=shard_rank, num_shards=num_shards,
            seqlen_fn=self._packing_length)
        if not dp_cfg.prefetch:
            return pipeline
        self._copy_stream = CopyStream(self.device)
        return DevicePrefetcher(pipeline, put_fn=self._prefetch_put,
                                depth=dp_cfg.prefetch_depth)

    def _stop_prefetch(self):
        loader = self.training_dataloader
        if isinstance(loader, DevicePrefetcher):
            loader.stop()

    def destroy(self):
        """Stop the data path's prefetch worker (its thread holds the
        engine). The engine stays usable: the next batch drawn restarts the
        worker."""
        self._stop_prefetch()

    def _host_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The rank's rows of ``batch`` (numpy arrays or tensors) as tensors
        where they lie, integer arrays as int64 (token ids, masks, segment
        ids, positions). Under a process group an array holds the global
        micro batch and the rank keeps its ``micro`` rows, or, when each
        rank packs its own (``shard: "process"``), the rank's ``micro``
        rows."""
        out = {}
        micro, dp = self.train_micro_batch_size_per_gpu, self.data_parallel_size
        for key, x in dict(batch).items():
            x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
            if self._data_parallel is not None and not (
                    self._local_rows and x.ndim and x.shape[0] == micro):
                if x.ndim == 0 or x.shape[0] != micro * dp:
                    raise ValueError(
                        f"batch leading dim {tuple(x.shape)} must be the "
                        f"global micro batch (train_micro_batch_size_per_gpu"
                        f" * dp = {micro} * {dp} = {micro * dp})")
                r = self.topology.data_parallel_rank()
                x = x[r * micro:(r + 1) * micro]
            if not x.is_floating_point() and x.dtype != torch.bool:
                x = x.long()
            out[key] = x
        return out

    def _prefetch_put(self, batch: Dict[str, Any]) -> PlacedBatch:
        """The prefetch worker's transfer: the rank's rows, through pinned
        memory, copied on the worker's own stream (``data/prefetch.py``
        ``CopyStream``)."""
        return self._copy_stream(self._host_batch(batch))

    def _put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The step's batch on the engine's device. A batch the prefetch
        worker placed (``PlacedBatch``, the port's counterpart of the JAX
        ``x.sharding == target`` pass-through, :1537-1540) is not sliced
        again: the current stream waits for its copies. Anything else goes
        through ``_host_batch``."""
        if isinstance(batch, PlacedBatch):
            return dict(batch.wait())
        return {k: x.to(self.device, non_blocking=True)
                for k, x in self._host_batch(batch).items()}

    def _apply_curriculum(self, batch):
        """Truncate sequence tensors to the scheduled difficulty (JAX engine
        :2044-2053; one captured graph per distinct length)."""
        seqlen = self.curriculum_scheduler.update_difficulty(
            self.global_steps + 1)
        return truncate_batch_to_difficulty(batch, seqlen)

    def _step_batch(self, batch):
        """``_put_batch``, then the curriculum's truncation (the JAX engine
        truncates before its transfer; on the sequence axis the two
        commute)."""
        batch = self._put_batch(batch)
        if self.curriculum_scheduler is not None:
            batch = self._apply_curriculum(batch)
        return batch

    @property
    def _data_parallel(self):
        """The data-parallel state (ZeRO's or the compressed exchange's), or
        None on the one-card engine."""
        return self._zero if self._zero is not None else self._cx

    def _phase(self) -> tuple:
        """The next step's host-known branch (the 1-bit optimizers'), a
        static key of the captured steps; () otherwise."""
        return self._cx.phase() if self._cx is not None else ()

    # -- the step functions (tensors only: no host read) --------------------
    def _update_loss_scale(self, overflow):
        if self.fp16_enabled and self._ls_config.dynamic:
            self._ls_state.copy_(update_loss_scale(self._ls_state, overflow,
                                                   self._ls_config))

    def _cx_update(self, phase):
        """The compressed exchange's update from its f32 sums (divided by
        the loss scale); returns ``(norm, overflow)``."""
        norm, overflow = self._cx.update(phase, self.fp16_enabled)
        self._update_loss_scale(overflow)
        return norm, overflow

    def _update(self, grads):
        """The update from gradients already divided by the loss scale
        (modified in place): the overflow flag (fp16 only), the global norm
        in f32, the clip, the cast to each parameter's dtype, the optimizer
        (skipped on the card on overflow) and the loss-scale update. Returns
        ``(norm, overflow)``, overflow None without fp16. ``grads`` are
        f32, or the parameters' own dtype when there was no scale to divide
        by: the norm accumulates in f32 and the clip multiply rounds once to
        the dtype either way, so both give the JAX step's values. Under
        ZeRO ``grads`` are the rank's part of the flat gradient, and the
        flag and the norm are global (``ZeroOptimizer``)."""
        z = self._zero
        if z is not None:
            overflow = z.overflow(grads) if self.fp16_enabled else None
            norm = (z.clip(grads, self._max_norm) if self._max_norm is not None
                    else z.global_norm(grads))
            z.apply(grads, skip=overflow)
        else:
            overflow = has_overflow(grads) if self.fp16_enabled else None
            if self._max_norm is not None:
                norm = clip_grad_norm_(grads, self._max_norm)
            else:
                norm = get_global_norm(grads)
            # g.astype(p.dtype): a new tensor only where the dtypes differ
            self.optimizer.apply(
                [g.to(p.dtype) for g, p in zip(grads, self._params)],
                skip=overflow)
        self._update_loss_scale(overflow)
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

    def _loss_share(self, batch):
        """This rank's share of the global batch's loss weights,
        ``max(local, 1) / max(global, 1)`` (a 0-dim f32 device tensor; one
        all-reduce): the rank's mean loss times it is its part of the global
        mean."""
        local = self.module.loss_weight_sum(**batch).float()
        total = self._data_parallel.data_parallel_sum(local)
        return local.clamp(min=1.0) / total.clamp(min=1.0)

    @property
    def _stage3(self) -> bool:
        return isinstance(self._zero, ZeroStage3Optimizer)

    def _model(self, **batch):
        """The model on ``batch``; at stage 3 with its outer unit gathered
        (each block gathers its own)."""
        if self._stage3:
            return self._zero.forward(**batch)
        return self.module(**batch)

    def _gating(self, batch) -> Dict[str, torch.Tensor]:
        """The training forward's gating noise (``{}`` for a dense model):
        every MoE layer's draws, drawn now from the gating generator into
        the buffer of this token count (made by the first, uncaptured call
        of a batch signature; a graph reads and writes it at each replay).
        As the JAX engine draws over the global batch, each rank draws the
        global micro batch's noise (the generators agree) and keeps its
        rows' slice."""
        if not self._gating_kinds:
            return {}
        cfg = self.module.config
        local = batch["input_ids"].numel()
        dp = self.data_parallel_size
        shape = (cfg.n_layer, len(self._gating_kinds), local * dp,
                 cfg.moe_num_experts)
        buf = self._gating_noise.get(shape)
        if buf is None:
            buf = self._gating_noise[shape] = torch.empty(
                shape, dtype=torch.float32, device=self.device)
        draw_gating_noise(buf, self._gating_kinds, self._gating_gen)
        r = self.topology.data_parallel_rank() if dp > 1 else 0
        return {"gating_noise": buf[:, :, r * local:(r + 1) * local]}

    def pld_theta(self) -> Optional[torch.Tensor]:
        """The step's ``pld_theta`` (a 0-dim f32 device tensor, the JAX
        engine's in-graph ``_pld_model_kwargs``): ``theta + (1 - theta)
        exp(-gamma t)`` at the device's global step t, for a stochastic-mode
        model (a GPT or a BERT) under ``progressive_layer_drop``; None otherwise."""
        if (self._pld_step is None
                or not self.module.config.stochastic_mode):
            return None
        pld = self._config.progressive_layer_drop
        return pld.theta + (1.0 - pld.theta) * torch.exp(
            -pld.gamma * self._pld_step)

    def _draws(self, batch) -> Dict[str, torch.Tensor]:
        """The training forward's random inputs: the gating noise, the
        dropout generator and ``pld_theta``, where the model has them."""
        draws = self._gating(batch)
        if self._dropout_gen is not None:
            # as the gating noise: each rank draws the global micro batch's
            # masks and keeps its rows (the stochastic-depth gates are per
            # layer, and equal on every rank)
            dp = self.data_parallel_size
            draws["dropout_generator"] = (
                self._dropout_gen if dp == 1 else GlobalBatchDraws(
                    self._dropout_gen, self.topology.data_parallel_rank(),
                    dp))
        theta = self.pld_theta()
        if theta is not None:
            draws["pld_theta"] = theta
        return draws

    def _advance_pld(self):
        """One more global step on the device's counter (inside the step
        that ends the window: the fused or the apply step)."""
        if self._pld_step is not None:
            self._pld_step.add_(1.0)

    def _fused_step(self, *phase, **batch):
        """gas == 1: gradients of ``loss * scale`` go straight to the update
        (no f32 accumulation buffer). Returns ``(loss, norm, overflow)``.
        ``phase``: the compressed exchange's branch."""
        loss = self._model(**batch, **self._draws(batch))
        self._advance_pld()
        if self._cx is not None:
            return self._cx_fused_step(loss, phase)
        if self._zero is not None:
            return self._zero_fused_step(loss, batch)
        if self.fp16_enabled:
            scale = self._ls_state.scale
            grads = [g.float() for g in self._grads_of(loss * scale)]
            torch._foreach_div_(grads, scale)
        else:
            grads = self._grads_of(loss)
        return (loss.detach(),) + self._update(grads)

    def _zero_fused_step(self, loss, batch):
        """gas == 1 under a process group: the backward of the rank's share
        of the global loss, the exchange (all-reduce at stage 0,
        reduce-scatter at 1-2; at stage 3 the backward reduce-scatters each
        unit, and the whole leaves are exchanged as at stage 2), the update
        of the rank's part. Returns the global mean loss, the norm and the
        overflow flag."""
        z = self._zero
        share = self._loss_share(batch)
        scaled = loss * share
        if self.fp16_enabled:
            scaled = scaled * self._ls_state.scale
        scaled.backward()
        z.collect_grads()
        grads = z.reduce_grads()
        if self.fp16_enabled:
            grads = [g.float() for g in grads]
            torch._foreach_div_(grads, self._ls_state.scale)
        norm, overflow = self._update(grads)
        return z.data_parallel_sum(loss * share), norm, overflow

    def _cx_fused_step(self, loss, phase):
        """gas == 1 under a compressed exchange: the backward of the rank's
        own mean loss, its gradient into the f32 sum (in the JAX layout),
        the exchange and the update. Returns the mean of the ranks' losses,
        the norm and the overflow flag."""
        cx = self._cx
        (loss * self._ls_state.scale if self.fp16_enabled else loss).backward()
        cx.collect(add=False)
        if self.fp16_enabled:
            cx.acc.div_(self._ls_state.scale)
        norm, overflow = self._cx_update(phase)
        return cx.mean_loss(loss), norm, overflow

    def _micro_step(self, **batch):
        """One micro batch: forward, backward of ``loss * scale / gas``, and
        the grads added in f32 to the accumulation buffers (under a process
        group: exchanged first, and the rank's share of the global loss).
        Returns the loss (the global mean under a group)."""
        loss = self._model(**batch, **self._draws(batch))
        factor = (self._ls_state.scale / self._gas if self.fp16_enabled
                  else 1.0 / self.gradient_accumulation_steps)
        if self._cx is not None:
            # the rank's own mean loss, its gradient added to its f32 sum:
            # the exchange waits for the boundary
            (loss * factor).backward()
            self._cx.collect(add=True)
            return self._cx.mean_loss(loss)
        z = self._zero
        if z is not None:
            share = self._loss_share(batch)
            (loss * (share * factor)).backward()
            z.collect_grads()
            z.accumulate()
            return z.data_parallel_sum(loss * share)
        for acc, g in zip(self._acc_grads, self._grads_of(loss * factor)):
            acc.add_(g)
        return loss.detach()

    def _apply_step(self, *phase):
        """The boundary: the update from the f32 sums themselves (divided
        and clipped in place), then the sums set to 0. Returns ``(norm,
        overflow)``. ``phase``: the compressed exchange's branch."""
        self._advance_pld()
        if self._cx is not None:
            if self.fp16_enabled:
                self._cx.acc.div_(self._ls_state.scale)
            out = self._cx_update(phase)
            self._cx.zero_accumulators()
            return out
        if self._zero is not None:
            grads = self._zero.accumulated()
            if self.fp16_enabled:
                torch._foreach_div_(grads, self._ls_state.scale)
            out = self._update(grads)
            self._zero.zero_accumulators()
            return out
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
        if not skipped and (self._cx is None or self._cx.norm_available):
            self._last_grad_norm = norm
        return skipped

    def _post_step(self, skipped):
        if skipped:
            self.skipped_steps += 1
            log_dist(f"overflow at step {self.global_steps}; loss scale -> "
                     f"{self.loss_scale}", ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
            # as in torch: a scheduler re-asserts the schedule over a
            # manual param_groups["lr"] set (see set_lr)
            self._lr_override = None
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self.global_steps)
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
        uncaptured on the card too (a reference for the captured steps).
        ``wall_clock_breakdown`` takes the forward / step path even at gas
        1, as the JAX engine does, so that each part is timed."""
        if (self.gradient_accumulation_steps == 1
                and not self.wall_clock_breakdown):
            return self._train_batch_fused(next(data_iter), eager)
        losses = []
        for _ in range(self.gradient_accumulation_steps):
            losses.append(self._forward(next(data_iter), eager))
            self.backward()
            self._step(eager)
        return torch.stack(losses).mean()

    @staticmethod
    def _run(step: CompiledStep, inputs, eager: bool, static=()):
        return step.eager(inputs, *static) if eager else step(inputs, *static)

    def _train_batch_fused(self, batch, eager=False):
        self.module.train()
        self.optimizer.prepare(self._lr_override)
        loss, norm, overflow = self._run(self._fused, self._step_batch(batch),
                                         eager, self._phase())
        skipped = self._finish_update(norm, overflow)
        self.micro_steps += 1
        self.global_steps += 1
        self.global_samples += (self.train_micro_batch_size_per_gpu
                                * self.data_parallel_size)
        self._post_step(skipped)
        self.tput_timer.stop(global_step=True)
        return loss

    def forward(self, batch: Dict[str, Any]):
        """The loss of one micro batch. Its gradients are computed with it
        (fused, as in the JAX engine) and added in f32 to the accumulation
        buffers; ``backward()`` then records the micro step."""
        return self._forward(batch, False)

    def _forward(self, batch, eager):
        if self.wall_clock_breakdown:
            self.timers(FORWARD_MICRO_TIMER).start()
        self.module.train()
        if self._zero is not None:
            self._zero.make_accumulators()
        elif self._cx is None and self._acc_grads is None:
            self._acc_grads = [torch.zeros_like(p, dtype=torch.float32)
                               for p in self._params]
        loss = self._run(self._micro, self._step_batch(batch), eager)
        self._pending_loss = loss
        if self.wall_clock_breakdown:
            self.timers(FORWARD_MICRO_TIMER).stop()
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
            if self.wall_clock_breakdown:
                self.timers(STEP_MICRO_TIMER).start()
            self.optimizer.prepare(self._lr_override)
            norm, overflow = self._run(self._apply, {}, eager, self._phase())
            skipped = self._finish_update(norm, overflow)
            self.global_steps += 1
            self._post_step(skipped)
            if self.wall_clock_breakdown:
                self.timers(STEP_MICRO_TIMER).stop()
                self.timers.log([FORWARD_MICRO_TIMER, STEP_MICRO_TIMER])
        self.micro_steps += 1
        self.global_samples += (self.train_micro_batch_size_per_gpu
                                * self.data_parallel_size)
        self.tput_timer.stop(global_step=at_boundary)

    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, Any]):
        """The loss (or logits, without labels) in eval mode; under a
        process group the global mean loss (or this rank's rows' logits)."""
        self.module.eval()
        try:
            batch = self._put_batch(batch)
            out = self._model(**batch)
            if self._data_parallel is not None and "labels" in batch:
                out = self._data_parallel.data_parallel_sum(
                    out * self._loss_share(batch))
            return out
        finally:
            self.module.train()

    __call__ = eval_batch

    # -- introspection ----------------------------------------------------
    def get_lr(self):
        if self._lr_override is not None:
            return [self._lr_override]
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()
        return [self._config.optimizer.params.get("lr", 0.0)]

    def get_global_grad_norm(self) -> Optional[float]:
        """Pre-clip global gradient norm of the last optimizer step (None
        before the first, and under the 1-bit optimizers unless
        ``tpu.compressed_grad_norm`` asks for it, as in the JAX engine)."""
        return None if self._last_grad_norm is None else float(self._last_grad_norm)

    @property
    def loss_scale(self) -> float:
        """The current loss scale (a read of the device state)."""
        return float(self._ls_state.scale)

    @property
    def params(self):
        """The model's ``state_dict``, every tensor whole (at stage 3
        gathered: a collective, every rank reads it)."""
        if self._stage3:
            return self._zero.gathered_state_dict()
        return self.module.state_dict()

    def _state_to_write(self):
        """The model state rank 0 writes, None on the other ranks; at stage
        3 gathered to the host unit by unit (a collective: every rank
        calls it)."""
        writer = comm.get_rank() == 0
        if self._stage3:
            return self._zero.gathered_state_dict(keep=writer, to_host=True)
        return self.module.state_dict() if writer else None

    def set_lr(self, lr: float) -> None:
        """Write-through lr (what ``optimizer.param_groups[0]["lr"] = lr``
        calls): an absolute lr from the next step on, in place of the
        schedule's. With an lr scheduler the override lasts one step (the
        scheduler's ``step()`` re-asserts the schedule, as torch schedulers
        overwrite a manual set); without one it persists. ``prepare`` writes
        it into the device scalars the captured step reads, so nothing is
        captured again. (The JAX engine multiplies the scheduled update by
        ``lr / scheduled_lr`` instead; the two agree to f32 rounding.) A
        client optimizer, which would own its lr, is not ported:
        ``initialize`` refuses one."""
        self._lr_override = float(lr)

    # -- checkpoints --------------------------------------------------------
    @staticmethod
    def _tag_path(ckpt_dir, tag, name):
        return os.path.join(ckpt_dir, str(tag), name)

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Save the model, the engine's counters and the optimizer under
        ``save_dir/tag`` (``tag`` defaults to ``global_step{n}``), commit
        the tag's manifest, then point ``latest`` at it and apply the
        ``checkpoint.keep_n`` retention. ``client_state`` holds plain Python
        values and tensors (what ``torch.load(weights_only=True)``
        reads back). A save in the middle of an accumulation window does
        not save the partial gradient sums (as in the JAX engine)."""
        if tag is None:
            tag = f"global_step{self.global_steps}"
        ce = self.checkpoint_engine
        # under a process group rank 0 writes every file; the others take
        # part in gathering the optimizer's shards (and at stage 3 the
        # parameters')
        writer = comm.get_rank() == 0
        module_sd = self._state_to_write()
        if writer:
            ce.set_topology_metadata(self._topology_metadata())
            ce.create(tag)
            self._save_sharded({"module": module_sd}, save_dir, tag,
                               MODEL_STATES, "model")
        del module_sd
        meta = {
            "global_steps": self.global_steps,
            "global_samples": self.global_samples,
            "micro_steps": self.micro_steps,
            "skipped_steps": self.skipped_steps,
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler else {}),
            "client_state": client_state or {},
        }
        if self._gating_gen is not None:
            meta["gating_generator"] = self._gating_gen.get_state()
        if self._dropout_gen is not None:
            meta["dropout_generator"] = self._dropout_gen.get_state()
        if self.training_dataloader is not None:
            # the loader's state as of the last batch consumed (with
            # prefetch: the one delivered, not the worker's); under a
            # process group every rank's, by rank (a packing rank's cursor
            # is its own), and rank 0's under the JAX key
            meta["dataloader"] = self.training_dataloader.state_dict()
            if self._distributed:
                meta["dataloader_by_rank"] = comm.all_gather_object(
                    meta["dataloader"])
        if writer:
            ce.save({"meta": meta},
                    self._tag_path(save_dir, tag, ENGINE_STATES))
        if self._cx is not None:
            # the optimizer by name and the error feedback, [k, ...]
            optim = self._cx.state_dict(keep=writer, to_host=True)
        else:
            optim = {"optimizer": (
                self.optimizer.state_dict() if self._zero is None
                else self._zero.state_dict(keep=writer, to_host=True))}
        if writer:
            self._save_sharded(
                dict(optim, loss_scale=dataclasses.asdict(self._ls_state)),
                save_dir, tag, OPTIM_STATES, "optim")
        del optim
        comm.barrier()  # every rank's part of the tag has been handed over
        if writer:
            # commit before advertising 'latest': with the async engine
            # the pointer must never name a tag whose files have not landed
            ce.commit(tag)
            if save_latest:
                ckpt_manifest.write_latest(save_dir, tag)
            self._gc_checkpoints(save_dir)
        comm.barrier()  # no rank reads the tag before it is committed
        return True

    def _save_sharded(self, payload, save_dir, tag, name, kind):
        """Write ``payload`` as the tag's file ``name``; its expert leaves
        (``moe_checkpoint``) go to one file per expert and the main file
        records them under ``moe_experts`` (JAX engine ``_save_sharded``).
        A dense model's payload is written as it is."""
        ce = self.checkpoint_engine
        info = moe_ckpt.find_expert_leaves(payload)
        if info:
            dense, meta, n_files = moe_ckpt.split_expert_state(payload, info)
            for e in range(n_files):
                ce.save({"experts": moe_ckpt.expert_slice(payload, info, e)},
                        self._tag_path(save_dir, tag,
                                       moe_ckpt.expert_states_filename(
                                           e, kind)))
            payload = dict(dense, moe_experts=meta)
        ce.save(payload, self._tag_path(save_dir, tag, name))

    def _topology_metadata(self):
        """The manifest's topology block: world, ZeRO stage, axis sizes and,
        under a process group, the flat partition."""
        specs = None
        if self._zero is not None:
            specs = layout.describe_partition(self._zero.rules,
                                              self._zero.groups)
        return layout.topology_metadata(self.topology, self.zero_stage,
                                        partition_specs=specs)

    def _gc_checkpoints(self, save_dir):
        """``checkpoint.keep_n``: keep the newest N valid tags, never the
        tag ``latest`` names nor a tag with an async write in flight."""
        keep_n = self._config.checkpoint_keep_n
        if keep_n <= 0:
            return
        protected = {ckpt_manifest.read_latest(save_dir)} - {None}
        protected |= self.checkpoint_engine.pinned_tags()
        tags = ckpt_manifest.find_valid_tags(save_dir, check_data=False)
        for tag in tags[keep_n:]:
            if tag in protected:
                continue
            try:
                shutil.rmtree(os.path.join(save_dir, tag))
                log_dist(f"[ckpt] retention keep_n={keep_n}: removed old "
                         f"tag {tag}", ranks=[0])
            except OSError as e:
                logger.warning("checkpoint GC failed for %s: %s", tag, e)

    def save_16bit_model(self, save_dir, save_filename="pytorch_model.pt"):
        """The weights in 16 bits (fp16 when training in fp16, else bf16)
        in one file, ``{"module": state_dict}``, written synchronously
        whatever the checkpoint engine (it is not part of a tag);
        ``init_inference(checkpoint=...)`` serves it."""
        dtype = torch.float16 if self.fp16_enabled else torch.bfloat16
        sd = self._state_to_write()
        if sd is not None:
            half = {k: v.to(dtype) for k, v in sd.items()}
            write_torch_file({"module": half},
                             os.path.join(save_dir, save_filename))
        comm.barrier()
        return True

    def _resolve_valid_tag(self, load_dir, tag):
        """``tag`` when it verifies against its manifest; otherwise the
        newest other valid tag, or a raise when there is none. A tag
        without a manifest loads unverified."""
        if not self._config.checkpoint_verify:
            return tag
        problems = ckpt_manifest.verify_tag_dir(
            os.path.join(load_dir, str(tag)))
        if problems is None:
            logger.info("checkpoint tag %s has no manifest; loading "
                        "unverified", tag)
            return tag
        if not problems:
            return tag
        logger.warning("checkpoint tag %s failed verification (%s); falling "
                       "back to the newest previous valid tag", tag,
                       "; ".join(problems))
        fallback = ckpt_manifest.latest_valid_tag(load_dir, exclude={str(tag)})
        if fallback is None:
            raise RuntimeError(
                f"checkpoint tag {tag!r} at {load_dir} is corrupt "
                f"({'; '.join(problems)}) and no previous valid tag "
                f"exists to fall back to")
        log_dist(f"[ckpt] falling back: {tag} -> {fallback}", ranks=[0])
        return fallback

    @torch.no_grad()
    def _restore_module(self, sd):
        """Copy a model ``state_dict`` into the live parameters and buffers
        (a tied weight is one tensor and one key, restored once; a
        stage-3 placeholder's slice into its unit's shard)."""
        own = self.module.state_dict(keep_vars=True)
        missing = sorted(set(own) - set(sd))
        unknown = sorted(set(sd) - set(own))
        if missing or unknown:
            raise KeyError(f"model state: missing {missing}, unknown "
                           f"{unknown}")
        for name, t in own.items():
            if hasattr(t, "ds_zero"):
                t.ds_zero.load_param(t, sd[name])
                continue
            if tuple(sd[name].shape) != tuple(t.shape):
                raise ValueError(f"model state {name}: shape "
                                 f"{tuple(sd[name].shape)}, want "
                                 f"{tuple(t.shape)}")
            t.copy_(sd[name])

    def _load_loader_state(self, meta):
        """The training loader's state from a tag: this rank's own when the
        tag was saved at this world (every rank resumes at its next
        document), else rank 0's, which the stream re-strides at another
        shard count (``data/streaming.py``; only shard 0 carries the
        pending rows, ``data/pipeline.py``). The curriculum's packing
        length restarts at the restored step."""
        by_rank = meta.get("dataloader_by_rank")
        state = meta["dataloader"]
        if by_rank is not None and len(by_rank) == comm.get_world_size():
            state = by_rank[comm.get_rank()]
        self.training_dataloader.load_state_dict(state)
        if self._packing_length is not None:
            self._packing_length.restart(self.micro_steps)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True):
        """Restore a tag saved by ``save_checkpoint`` (``tag`` defaults to
        the one ``latest`` names) and return ``(tag, client_state)``, or
        ``(None, {})`` when there is no ``latest``. A tag that fails
        verification falls back to the newest valid one.

        Every tensor is copied into the storage it already has (the
        parameters, the optimizer's moments, the loss-scale state), so the
        captured graphs stay valid; the f32 gradient sums of a partial
        accumulation window are set to 0 in place (the JAX engine drops
        them); the clip bound and the accumulation divisor, device
        constants of the config, stay as they are. Unlike the JAX engine, which needs one step first to build
        its state templates, the port holds its parameters from ``init``,
        so a load before the first step is legal."""
        if tag is None:
            tag = ckpt_manifest.read_latest(load_dir)
            if tag is None:
                logger.warning("no 'latest' file at %s", load_dir)
                return None, {}
        tag = self._resolve_valid_tag(load_dir, tag)
        # a tag of another world or stage loads all the same: each rank
        # copies its slice of the whole tensors
        self.last_reshard = reshard.decide(load_dir, tag, self.topology,
                                           zero_stage=self.zero_stage)
        if self.last_reshard.needed:
            log_dist(f"[ckpt] resharding tag {tag}: "
                     f"{self.last_reshard.describe()}", ranks=[0])
        specs = (self.last_reshard.saved or {}).get("partition_specs") or {}
        load = self.checkpoint_engine.load
        tag_dir = os.path.join(load_dir, str(tag))
        module_sd = moe_ckpt.load_with_experts(load, tag_dir, MODEL_STATES,
                                               "model")["module"]
        reshard.verify_state_dict(module_sd, specs.get("params", {}), "model")
        self._restore_module(module_sd)
        meta = load(self._tag_path(load_dir, tag, ENGINE_STATES))["meta"]
        self.global_steps = int(meta["global_steps"])
        self.global_samples = int(meta["global_samples"])
        self.micro_steps = int(meta["micro_steps"])
        self.skipped_steps = int(meta["skipped_steps"])
        if self._gating_gen is not None and "gating_generator" in meta:
            self._gating_gen.set_state(meta["gating_generator"])
        if self._dropout_gen is not None and "dropout_generator" in meta:
            self._dropout_gen.set_state(meta["dropout_generator"])
        if self.progressive_layer_drop is not None:
            # the device counter in place (the graphs read it)
            self._pld_step.fill_(float(self.global_steps))
            self.progressive_layer_drop.update_state(self.global_steps)
        if meta.get("dataloader") and self.training_dataloader is not None:
            self._load_loader_state(meta)
        if (load_lr_scheduler_states and self.lr_scheduler is not None
                and meta.get("lr_scheduler")):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        if load_optimizer_states:
            optim = moe_ckpt.load_with_experts(load, tag_dir, OPTIM_STATES,
                                               "optim")
            reshard.verify_state_dict(optim["optimizer"]["state"],
                                      specs.get("opt_state", {}), "optimizer")
            if self._cx is not None:
                self._cx.load_state(optim)
            else:
                self.optimizer.load_state_dict(optim["optimizer"])
            self._ls_state.copy_(LossScaleState(**optim["loss_scale"]))
        # a partial accumulation window must not leak into the next step;
        # the micro and apply graphs read these buffers, so zero in place
        if self._acc_grads is not None:
            for acc in self._acc_grads:
                acc.zero_()
        if self._data_parallel is not None:
            self._data_parallel.zero_accumulators()
        self._pending_loss = None
        return tag, meta.get("client_state", {})
