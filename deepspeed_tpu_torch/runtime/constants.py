"""Config keys and defaults (counterpart of
``deepspeed_tpu/runtime/constants.py``): the port's own copy of the keys its
config parser reads, with the JAX package's defaults, so that one DeepSpeed
JSON drives both packages."""

# batch triad
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"

STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

# optimizer / scheduler blocks
OPTIMIZER = "optimizer"
SCHEDULER = "scheduler"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
CPU_ADAM_OPTIMIZER = "cpuadam"
CPU_ADAGRAD_OPTIMIZER = "cpuadagrad"
ADAGRAD_OPTIMIZER = "adagrad"
LAMB_OPTIMIZER = "lamb"
FUSED_LAMB_OPTIMIZER = "fusedlamb"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
SGD_OPTIMIZER = "sgd"
ONEBIT_OPTIMIZERS = (ONEBIT_ADAM_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER,
                     ONEBIT_LAMB_OPTIMIZER)

# precision
FP16 = "fp16"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE_DEFAULT = 0  # 0 => dynamic
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE_DEFAULT = 1
FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT = False
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"
BFLOAT16_ENABLED_DEFAULT = False
AMP = "amp"
AMP_ENABLED_DEFAULT = False

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS = "prescale_gradients"
PRESCALE_GRADIENTS_DEFAULT = False
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
GRADIENT_PREDIVIDE_FACTOR_DEFAULT = 1.0

# misc runtime knobs
DUMP_STATE = "dump_state"
DUMP_STATE_DEFAULT = False
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
MEMORY_BREAKDOWN = "memory_breakdown"
MEMORY_BREAKDOWN_DEFAULT = False
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False
ZERO_ALLOW_UNTESTED_OPTIMIZER = "zero_allow_untested_optimizer"
ZERO_ALLOW_UNTESTED_OPTIMIZER_DEFAULT = False
DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = True

CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
LOAD_UNIVERSAL_CHECKPOINT_DEFAULT = False
CHECKPOINT_KEEP_N = "keep_n"
CHECKPOINT_KEEP_N_DEFAULT = 0  # 0 = keep every tag
CHECKPOINT_VERIFY = "verify"
CHECKPOINT_VERIFY_DEFAULT = True
GRACEFUL_SHUTDOWN = "graceful_shutdown"
SENTINEL = "sentinel"
TELEMETRY = "telemetry"

# feature blocks
PIPELINE = "pipeline"
ZERO_OPTIMIZATION = "zero_optimization"
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
SPARSE_ATTENTION = "sparse_attention"
CURRICULUM_LEARNING = "curriculum_learning"
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
EIGENVALUE = "eigenvalue"
FLOPS_PROFILER = "flops_profiler"
AUTOTUNING = "autotuning"
ELASTICITY = "elasticity"
COMPRESSION_TRAINING = "compression_training"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"
MONITOR_CSV = "csv_monitor"
COMMS_LOGGER = "comms_logger"
STEP_PROFILER = "step_profiler"
DATA_PIPELINE = "data_pipeline"
AIO = "aio"
NEBULA = "nebula"
QUANTIZE_TRAINING = "quantize_training"
DATA_EFFICIENCY = "data_efficiency"

# the device block, read under its JAX name so one JSON drives both packages
TPU = "tpu"

COMMUNICATION_DATA_TYPE = "communication_data_type"
COMMUNICATION_DATA_TYPE_DEFAULT = None
COMMUNICATION_DATA_TYPES = ["fp16", "bfp16", "bf16", "fp32", "int8"]
