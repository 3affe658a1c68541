"""DeepSpeed-style JSON config (counterpart of
``deepspeed_tpu/runtime/config.py``).

Every block and key the JAX package accepts still parses, into the same
dataclasses, so one JSON drives both packages; the device block is read
under its JAX name ``tpu``. The training slice honours the batch triad
(resolved by the engine at its data-parallel size: 1 without a process
group), ``fp16`` with its loss-scale keys, ``bf16``,
``gradient_clipping``, ``optimizer``, ``scheduler``, ``steps_per_print``,
``zero_optimization.stage`` 0-2 (and 3 on one rank), ``tpu.mesh`` over dp
and fsdp, ``communication_data_type`` fp32 / bf16 (bfp16) / fp16 (the
dtype of the gradient exchange; unset, the gradients' own),
``comms_logger``, ``tpu.use_pallas_optimizer``, ``sparse_attention``
(applied by the engine), ``data_pipeline`` and ``curriculum_learning``
(the engine's data path), ``checkpoint`` (``keep_n``, ``verify``,
``tag_validation``), ``nebula`` (the asynchronous checkpoint engine) and
``wall_clock_breakdown``; ``amp`` parses and is inert, as in the JAX
package (which keeps it for config compatibility and reads it nowhere).
``unported_features()`` names every other block
that is enabled, with the ROADMAP item that ports it; the engine refuses
to train with any of them.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from deepspeed_tpu_torch.runtime import constants as C
from deepspeed_tpu_torch.runtime.config_utils import (
    ConfigModel,
    dict_raise_error_on_duplicate_keys,
    get_scalar_param,
    pretty_json,
)
from deepspeed_tpu_torch.utils.logging import logger


class DeepSpeedConfigError(Exception):
    pass


@dataclass
class Fp16Config(ConfigModel):
    enabled: bool = C.FP16_ENABLED_DEFAULT
    loss_scale: float = C.FP16_LOSS_SCALE_DEFAULT
    initial_scale_power: int = C.FP16_INITIAL_SCALE_POWER_DEFAULT
    loss_scale_window: int = C.FP16_LOSS_SCALE_WINDOW_DEFAULT
    hysteresis: int = C.FP16_HYSTERESIS_DEFAULT
    min_loss_scale: float = C.FP16_MIN_LOSS_SCALE_DEFAULT
    fp16_master_weights_and_grads: bool = C.FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT
    auto_cast: bool = False

    @property
    def dynamic_loss_scale(self) -> bool:
        return self.loss_scale == 0


@dataclass
class Bf16Config(ConfigModel):
    enabled: bool = C.BFLOAT16_ENABLED_DEFAULT


@dataclass
class AmpConfig(ConfigModel):
    enabled: bool = C.AMP_ENABLED_DEFAULT
    opt_level: str = "O1"


@dataclass
class ZeroConfig(ConfigModel):
    """``zero_optimization``. Stages 0-3 run under a process group
    (``runtime/zero/``); stage 3 partitions each parameter of at least
    ``param_persistence_threshold`` elements
    (``stage3_param_persistence_threshold``) unit by unit. The prefetch and
    live-parameter knobs (``stage3_prefetch_bucket_size``,
    ``stage3_max_live_parameters``, ``stage3_max_reuse_distance``) parse and
    are inert, as in the JAX package; ``offload_param`` and
    ``offload_optimizer`` raise (ROADMAP A.10)."""

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = False
    load_from_fp32_weights: bool = True
    elastic_checkpoint: bool = False
    offload_param: Optional[Dict[str, Any]] = None
    offload_optimizer: Optional[Dict[str, Any]] = None
    sub_group_size: int = 1_000_000_000
    cpu_offload: bool = False
    cpu_offload_param: bool = False
    prefetch_bucket_size: int = 50_000_000
    param_persistence_threshold: int = 100_000
    model_persistence_threshold: int = 2 ** 62
    max_live_parameters: int = 1_000_000_000
    max_reuse_distance: int = 1_000_000_000
    gather_16bit_weights_on_model_save: bool = False
    stage3_gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    round_robin_gradients: bool = False
    zero_hpz_partition_size: int = 1
    _aliases = {
        "stage3_prefetch_bucket_size": "prefetch_bucket_size",
        "stage3_param_persistence_threshold": "param_persistence_threshold",
        "stage3_model_persistence_threshold": "model_persistence_threshold",
        "stage3_max_live_parameters": "max_live_parameters",
        "stage3_max_reuse_distance": "max_reuse_distance",
    }

    def __post_init__validate__(self):
        if self.stage not in (0, 1, 2, 3):
            raise DeepSpeedConfigError(f"ZeRO stage must be 0..3, got {self.stage}")
        if self.cpu_offload and self.offload_optimizer is None:
            self.offload_optimizer = {"device": "cpu"}
        if self.cpu_offload_param and self.offload_param is None:
            self.offload_param = {"device": "cpu"}
        if self.stage3_gather_16bit_weights_on_model_save:
            self.gather_16bit_weights_on_model_save = True


@dataclass
class OptimizerConfig(ConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)
    legacy_fusion: bool = False


@dataclass
class SchedulerConfig(ConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ActivationCheckpointingConfig(ConfigModel):
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclass
class FlopsProfilerConfig(ConfigModel):
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclass
class TensorboardConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class WandbConfig(ConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


@dataclass
class CsvConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclass
class CommsLoggerConfig(ConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@dataclass
class StepProfilerConfig(ConfigModel):
    enabled: bool = False
    start_step: int = 2
    num_steps: int = 8
    trace_path: Optional[str] = None
    jax_trace: bool = False
    jax_trace_dir: Optional[str] = None
    peak_tflops: Optional[float] = None
    emit_counters: bool = True


@dataclass
class DataPipelineConfig(ConfigModel):
    """The input data pipeline (``deepspeed_tpu_torch/data/``; JAX
    ``config.py:243-281``): sharded streaming, sequence packing and
    background prefetch to the card in place of ``DeepSpeedDataLoader``."""

    enabled: bool = False
    # bin-pack variable-length documents into [B, seq_length] with
    # segment_ids/positions; False collates one sample per row instead
    pack_sequences: bool = True
    seq_length: int = 1024
    pad_token_id: int = 0
    shuffle: bool = True
    seed: int = 0
    # "process": each data-parallel rank packs its own rows from its own
    # stride of the stream; "none": every rank packs the same global micro
    # batch and keeps its rows (runtime/engine.py deepspeed_io)
    shard: str = "process"
    # a worker thread packs and copies batch N+1 to the card (pinned
    # memory, a stream of its own) while the step of batch N runs
    prefetch: bool = True
    prefetch_depth: int = 2
    # pack to the curriculum scheduler's quantized difficulty
    curriculum_pack: bool = True

    def __post_init__validate__(self):
        if self.seq_length < 2:
            raise DeepSpeedConfigError(
                "data_pipeline.seq_length must be >= 2")
        if self.prefetch_depth < 1:
            raise DeepSpeedConfigError(
                "data_pipeline.prefetch_depth must be >= 1")
        if self.shard not in ("process", "none"):
            raise DeepSpeedConfigError(
                f"data_pipeline.shard must be 'process' or 'none', got "
                f"{self.shard!r}")


@dataclass
class CurriculumConfig(ConfigModel):
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 1
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ProgressiveLayerDropConfig(ConfigModel):
    enabled: bool = False
    theta: float = 0.5
    gamma: float = 0.001


@dataclass
class EigenvalueConfig(ConfigModel):
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "bert.encoder.layer"
    layer_num: int = 0


@dataclass
class AioConfig(ConfigModel):
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclass
class PipelineConfig(ConfigModel):
    stages: Any = "auto"
    partition: str = "best"
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True


@dataclass
class GracefulShutdownConfig(ConfigModel):
    enabled: bool = False
    save_dir: Optional[str] = None
    tag: Optional[str] = None
    signals: List[str] = field(default_factory=lambda: ["SIGTERM", "SIGINT"])
    exit_after_save: bool = True
    exit_code: int = 0


@dataclass
class SentinelConfig(ConfigModel):
    enabled: bool = False
    check_nonfinite: bool = True
    window: int = 50
    min_window: int = 10
    loss_spike_zscore: float = 6.0
    loss_spike_ratio: float = 3.0
    grad_spike_zscore: float = 6.0
    grad_spike_ratio: float = 10.0
    skip_budget: int = 3
    rollback_budget: int = 2
    rollback_dir: Optional[str] = None
    reseed_on_rollback: bool = True
    divergence_exit_code: int = 13
    hang_timeout_s: float = 0.0
    hang_action: str = "warn"
    hang_exit_code: int = 14


@dataclass
class TelemetryConfig(ConfigModel):
    enabled: bool = True
    ring_steps: int = 64
    ring_events: int = 256
    dump_dir: Optional[str] = None
    sample_memory: bool = True
    dump_signals: List[str] = field(default_factory=lambda: ["SIGTERM"])


@dataclass
class NebulaConfig(ConfigModel):
    enabled: bool = False
    persistent_storage_path: str = ""
    persistent_time_interval: int = 100
    num_of_version_in_retention: int = 2
    enable_nebula_load: bool = True


@dataclass
class MeshConfig(ConfigModel):
    """Device-mesh axis sizes; -1 on ``dp`` means all remaining devices."""

    dp: int = -1
    fsdp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    sp: int = 1


@dataclass
class GradExchangeConfig(ConfigModel):
    """The explicit gradient exchange (``comm/bucketed.py``,
    ``runtime/compressed_exchange.py``): ``deferred`` exchanges each rank's
    f32 gradient sum once per step, in buckets of ``bucket_mb`` (which also
    buckets the int8 exchange; 0 is one leaf per bucket), at ``wire_dtype``
    (bf16 | fp32); ``hierarchical`` (off | auto | on) the two-level
    exchange over ``dcn_slices`` slices of the dp axis (0: the hosts), its
    int8 leg in blocks of ``dcn_block``."""

    bucket_mb: float = 0.0
    deferred: bool = False
    wire_dtype: str = "bf16"
    hierarchical: str = "off"
    dcn_slices: int = 0
    dcn_block: int = 512

    def __post_init__validate__(self):
        if self.wire_dtype not in ("bf16", "bfloat16", "fp32", "float32"):
            raise DeepSpeedConfigError(
                "tpu.grad_exchange.wire_dtype must be one of bf16/bfloat16/"
                f"fp32/float32, got {self.wire_dtype!r}")
        if self.bucket_mb < 0:
            raise DeepSpeedConfigError(
                f"tpu.grad_exchange.bucket_mb must be >= 0, got "
                f"{self.bucket_mb}")
        if self.hierarchical not in ("off", "auto", "on"):
            raise DeepSpeedConfigError(
                "tpu.grad_exchange.hierarchical must be one of off/auto/on,"
                f" got {self.hierarchical!r}")
        if self.dcn_slices < 0:
            raise DeepSpeedConfigError(
                f"tpu.grad_exchange.dcn_slices must be >= 0, got "
                f"{self.dcn_slices}")
        if self.dcn_block < 1:
            raise DeepSpeedConfigError(
                f"tpu.grad_exchange.dcn_block must be >= 1, got "
                f"{self.dcn_block}")


@dataclass
class StepAutotuneConfig(ConfigModel):
    enabled: bool = False
    autotune: bool = False
    apply_micro_batch: bool = False
    fused_step: str = "auto"
    hbm_gib: float = 0.0
    live_steps: int = 3
    micro_batches: List[int] = field(default_factory=list)
    policies: List[str] = field(default_factory=list)


@dataclass
class ClusterHealthConfig(ConfigModel):
    enabled: Any = "auto"
    host: str = "127.0.0.1"
    port_base: int = 29700
    peers: List[str] = field(default_factory=list)
    beat_interval_s: float = 0.5
    suspect_after_s: float = 2.0
    down_after_s: float = 6.0
    recover_probes: int = 2
    abort_on_peer_loss: bool = True
    exit_code: int = 15
    digest_every_k: int = 0
    sdc_action: str = "abort"
    straggler_ratio: float = 1.5
    straggler_min_peers: int = 2
    ewma_alpha: float = 0.2
    step_skew_threshold: int = 10


@dataclass
class TpuConfig(ConfigModel):
    """The JAX package's device block. ``use_pallas_optimizer`` routes
    FusedAdam to the fused AdamW kernel (on the card: B4)."""

    mesh: Dict[str, Any] = field(default_factory=dict)
    remat: str = "none"
    donate_params: bool = True
    matmul_precision: str = "default"
    use_pallas_optimizer: bool = False
    compressed_grad_norm: bool = False
    grad_exchange: Dict[str, Any] = field(default_factory=dict)
    step_autotune: Dict[str, Any] = field(default_factory=dict)
    pipeline: Dict[str, Any] = field(default_factory=dict)
    cluster_health: Dict[str, Any] = field(default_factory=dict)

    @property
    def mesh_config(self) -> MeshConfig:
        return MeshConfig.from_dict(self.mesh)

    @property
    def grad_exchange_config(self) -> GradExchangeConfig:
        return GradExchangeConfig.from_dict(self.grad_exchange)

    @property
    def step_autotune_config(self) -> StepAutotuneConfig:
        return StepAutotuneConfig.from_dict(self.step_autotune)

    @property
    def cluster_health_config(self) -> ClusterHealthConfig:
        return ClusterHealthConfig.from_dict(self.cluster_health)


class DeepSpeedConfig:
    """Parses a DeepSpeed JSON config (path or dict) and resolves the batch
    triad ``train_batch_size = micro_batch * grad_accum * dp_world``."""

    def __init__(self, config, dp_world_size: Optional[int] = None):
        if isinstance(config, str):
            if not os.path.exists(config):
                raise DeepSpeedConfigError(f"config path does not exist: {config}")
            with open(config, "r") as f:
                self._param_dict = json.load(
                    f, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            self._param_dict = dict(config)
        else:
            raise DeepSpeedConfigError(
                f"config must be a path or dict, got {type(config)}")
        self.dp_world_size = dp_world_size
        self._initialize(self._param_dict)

    def _initialize(self, pd: Dict[str, Any]):
        scalar = get_scalar_param
        self.train_batch_size = scalar(pd, C.TRAIN_BATCH_SIZE, None)
        self.train_micro_batch_size_per_gpu = scalar(
            pd, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, None)
        self.gradient_accumulation_steps = scalar(
            pd, C.GRADIENT_ACCUMULATION_STEPS, None)
        self.steps_per_print = scalar(pd, C.STEPS_PER_PRINT,
                                      C.STEPS_PER_PRINT_DEFAULT)
        self.gradient_clipping = scalar(pd, C.GRADIENT_CLIPPING,
                                        C.GRADIENT_CLIPPING_DEFAULT)
        self.prescale_gradients = scalar(pd, C.PRESCALE_GRADIENTS,
                                         C.PRESCALE_GRADIENTS_DEFAULT)
        self.gradient_predivide_factor = scalar(
            pd, C.GRADIENT_PREDIVIDE_FACTOR, C.GRADIENT_PREDIVIDE_FACTOR_DEFAULT)
        self.sparse_gradients_enabled = scalar(pd, C.SPARSE_GRADIENTS,
                                               C.SPARSE_GRADIENTS_DEFAULT)
        self.wall_clock_breakdown = scalar(pd, C.WALL_CLOCK_BREAKDOWN,
                                           C.WALL_CLOCK_BREAKDOWN_DEFAULT)
        self.memory_breakdown = scalar(pd, C.MEMORY_BREAKDOWN,
                                       C.MEMORY_BREAKDOWN_DEFAULT)
        self.dump_state = scalar(pd, C.DUMP_STATE, C.DUMP_STATE_DEFAULT)
        self.dataloader_drop_last = scalar(pd, C.DATALOADER_DROP_LAST,
                                           C.DATALOADER_DROP_LAST_DEFAULT)
        self.zero_allow_untested_optimizer = scalar(
            pd, C.ZERO_ALLOW_UNTESTED_OPTIMIZER,
            C.ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT)
        self.communication_data_type = scalar(
            pd, C.COMMUNICATION_DATA_TYPE, C.COMMUNICATION_DATA_TYPE_DEFAULT)
        if self.communication_data_type is not None and (
                self.communication_data_type not in C.COMMUNICATION_DATA_TYPES):
            raise DeepSpeedConfigError(
                f"Invalid {C.COMMUNICATION_DATA_TYPE}. Supported: "
                f"{C.COMMUNICATION_DATA_TYPES}. Got: "
                f"{self.communication_data_type}")

        self.fp16 = Fp16Config.from_dict(pd.get(C.FP16, {}))
        self.bf16 = Bf16Config.from_dict(pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD, {})))
        self.amp = AmpConfig.from_dict(pd.get(C.AMP, {}))
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        self.zero_config = ZeroConfig.from_dict(pd.get(C.ZERO_OPTIMIZATION, {}))
        self.optimizer = OptimizerConfig.from_dict(pd.get(C.OPTIMIZER, {}))
        self.scheduler = SchedulerConfig.from_dict(pd.get(C.SCHEDULER, {}))
        self.activation_checkpointing = ActivationCheckpointingConfig.from_dict(
            pd.get(C.ACTIVATION_CHECKPOINTING, {}))
        self.flops_profiler = FlopsProfilerConfig.from_dict(
            pd.get(C.FLOPS_PROFILER, {}))
        self.tensorboard = TensorboardConfig.from_dict(
            pd.get(C.MONITOR_TENSORBOARD, {}))
        self.wandb = WandbConfig.from_dict(pd.get(C.MONITOR_WANDB, {}))
        self.csv_monitor = CsvConfig.from_dict(pd.get(C.MONITOR_CSV, {}))
        self.comms_logger = CommsLoggerConfig.from_dict(pd.get(C.COMMS_LOGGER, {}))
        self.step_profiler = StepProfilerConfig.from_dict(
            pd.get(C.STEP_PROFILER, {}))
        self.data_pipeline = DataPipelineConfig.from_dict(
            pd.get(C.DATA_PIPELINE, {}))
        self.curriculum_learning = CurriculumConfig.from_dict(
            pd.get(C.CURRICULUM_LEARNING, {}))
        self.progressive_layer_drop = ProgressiveLayerDropConfig.from_dict(
            pd.get(C.PROGRESSIVE_LAYER_DROP, {}))
        self.eigenvalue = EigenvalueConfig.from_dict(pd.get(C.EIGENVALUE, {}))
        self.aio = AioConfig.from_dict(pd.get(C.AIO, {}))
        self.pipeline = PipelineConfig.from_dict(pd.get(C.PIPELINE, {}))
        self.tpu = TpuConfig.from_dict(pd.get(C.TPU, {}))
        self.sparse_attention = pd.get(C.SPARSE_ATTENTION, None)
        self.elasticity = pd.get(C.ELASTICITY, {})
        self.autotuning = pd.get(C.AUTOTUNING, {})
        self.compression_training = pd.get(C.COMPRESSION_TRAINING, {})
        self.data_efficiency = pd.get(C.DATA_EFFICIENCY, {})
        self.quantize_training = pd.get(C.QUANTIZE_TRAINING, {})
        self.nebula = NebulaConfig.from_dict(pd.get(C.NEBULA, {}))
        ckpt = pd.get(C.CHECKPOINT, {}) or {}
        self.checkpoint_tag_validation = str(ckpt.get(
            C.CHECKPOINT_TAG_VALIDATION,
            C.CHECKPOINT_TAG_VALIDATION_DEFAULT)).title()
        if self.checkpoint_tag_validation not in C.CHECKPOINT_TAG_VALIDATION_MODES:
            raise DeepSpeedConfigError(
                f"checkpoint.tag_validation must be one of "
                f"{C.CHECKPOINT_TAG_VALIDATION_MODES}")
        self.load_universal_checkpoint = ckpt.get(
            C.LOAD_UNIVERSAL_CHECKPOINT, C.LOAD_UNIVERSAL_CHECKPOINT_DEFAULT)
        self.checkpoint_keep_n = int(ckpt.get(C.CHECKPOINT_KEEP_N,
                                              C.CHECKPOINT_KEEP_N_DEFAULT))
        if self.checkpoint_keep_n < 0:
            raise DeepSpeedConfigError(
                f"checkpoint.keep_n must be >= 0 (0 = keep all), got "
                f"{self.checkpoint_keep_n}")
        self.checkpoint_verify = bool(ckpt.get(C.CHECKPOINT_VERIFY,
                                               C.CHECKPOINT_VERIFY_DEFAULT))
        self.graceful_shutdown = GracefulShutdownConfig.from_dict(
            pd.get(C.GRACEFUL_SHUTDOWN, {}))
        self.sentinel = SentinelConfig.from_dict(pd.get(C.SENTINEL, {}))
        self.telemetry = TelemetryConfig.from_dict(pd.get(C.TELEMETRY, {}))
        if self.dp_world_size is not None:
            self._resolve_batch_triad(self.dp_world_size)

    def _resolve_batch_triad(self, dp_world_size: int):
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        for name, v in ((C.TRAIN_BATCH_SIZE, train),
                        (C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, micro),
                        (C.GRADIENT_ACCUMULATION_STEPS, gas)):
            if v is not None and v <= 0:
                raise DeepSpeedConfigError(f"{name} must be positive, got {v}")
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp_world_size)
        elif train is not None and gas is not None:
            micro = train // (gas * dp_world_size)
        elif micro is not None and gas is not None:
            train = micro * gas * dp_world_size
        elif train is not None:
            gas = 1
            micro = train // dp_world_size
        elif micro is not None:
            gas = 1
            train = micro * dp_world_size
        else:
            raise DeepSpeedConfigError(
                "At least one of train_batch_size or "
                "train_micro_batch_size_per_gpu must be set")
        if micro is None or micro <= 0 or gas is None or gas <= 0:
            raise DeepSpeedConfigError(
                f"Could not resolve a positive batch triad from "
                f"train={self.train_batch_size} micro="
                f"{self.train_micro_batch_size_per_gpu} "
                f"gas={self.gradient_accumulation_steps} dp={dp_world_size}")
        if train != micro * gas * dp_world_size:
            raise DeepSpeedConfigError(
                f"Batch triad inconsistent: train_batch_size {train} != "
                f"micro_batch {micro} * grad_accum {gas} * dp {dp_world_size}")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    def unported_features(self) -> List[str]:
        """Names of the enabled blocks (and settings) the port does not
        implement yet; the engine raises ``NotImplementedError`` naming them.
        Blocks left at their defaults parse and are inert."""
        zero = self.zero_config
        mesh = self.tpu.mesh_config
        checks = [
            ("zero_optimization.offload_optimizer (optimizer offload, "
             "ROADMAP A.10)",
             (zero.offload_optimizer or {}).get("device", "none") != "none"),
            ("zero_optimization.offload_param (parameter offload, "
             "ROADMAP A.10)",
             (zero.offload_param or {}).get("device", "none") != "none"),
            ("sentinel (ROADMAP A.11)", self.sentinel.enabled),
            ("step_profiler (ROADMAP A.11)", self.step_profiler.enabled),
            ("flops_profiler (ROADMAP A.11)", self.flops_profiler.enabled),
            ("tensorboard (ROADMAP A.11)", self.tensorboard.enabled),
            ("wandb (ROADMAP A.11)", self.wandb.enabled),
            ("csv_monitor (ROADMAP A.11)", self.csv_monitor.enabled),
            ("graceful_shutdown (ROADMAP A.11)",
             self.graceful_shutdown.enabled),
            ("pipeline (ROADMAP A.9 part 3)",
             self.pipeline.to_dict() != PipelineConfig().to_dict()),
            ("activation_checkpointing.cpu_checkpointing (activation "
             "offload, ROADMAP A.10)",
             bool(self.activation_checkpointing.cpu_checkpointing)),
            ("tpu.mesh pp/sp > 1 (the pipeline and sequence axes, ROADMAP "
             "A.9 parts 2-3)",
             any(getattr(mesh, ax) != 1 for ax in ("pp", "sp"))),
            ("tpu.step_autotune (ROADMAP A.12)",
             self.tpu.step_autotune_config.enabled),
            ("tpu.cluster_health (ROADMAP A.11)",
             self.tpu.cluster_health_config.enabled is True),
            ("eigenvalue (ROADMAP A.12)", self.eigenvalue.enabled),
            ("compression_training (ROADMAP A.12)",
             bool(self.compression_training)),
            ("quantize_training (ROADMAP A.12)",
             bool(self.quantize_training.get("enabled", False))),
            ("checkpoint.load_universal (the universal checkpoint, "
             "ROADMAP A.12)", bool(self.load_universal_checkpoint)),
        ]
        return [name for name, enabled in checks if enabled]

    @property
    def communication_dtype(self):
        """The torch dtype of the ZeRO gradient exchange, or None for the
        gradients' own dtype (and for int8, which the compressed exchange
        carries: ``runtime/compressed_exchange.py``)."""
        import torch

        return {None: None, "fp32": torch.float32, "fp16": torch.float16,
                "bf16": torch.bfloat16, "bfp16": torch.bfloat16,
                "int8": None}[
                    self.communication_data_type]

    @property
    def zero_enabled(self) -> bool:
        return self.zero_config.stage > 0

    @property
    def precision_dtype(self) -> str:
        if self.bf16.enabled:
            return "bfloat16"
        if self.fp16.enabled:
            return "float16"
        return "float32"

    def print_config(self):
        logger.info("DeepSpeedConfig:\n%s", pretty_json(self._param_dict))
