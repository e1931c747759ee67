"""Config key constants and defaults (counterpart of
``deepspeed_tpu/runtime/constants.py``; the keys the port's training
slice reads, with the JAX package's defaults)."""

TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10

OPTIMIZER = "optimizer"
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
SCHEDULER = "scheduler"
SCHEDULER_PARAMS = "params"
ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
LAMB_OPTIMIZER = "lamb"
SGD_OPTIMIZER = "sgd"
ADAGRAD_OPTIMIZER = "adagrad"

FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_ENABLED_DEFAULT = False
FP16_LOSS_SCALE = "loss_scale"
FP16_LOSS_SCALE_DEFAULT = 0            # 0 = dynamic loss scaling
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_INITIAL_SCALE_POWER_DEFAULT = 16
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_LOSS_SCALE_WINDOW_DEFAULT = 1000
FP16_HYSTERESIS = "hysteresis"
FP16_HYSTERESIS_DEFAULT = 2
FP16_MIN_LOSS_SCALE = "min_loss_scale"
FP16_MIN_LOSS_SCALE_DEFAULT = 1
FP16_MASTER_WEIGHTS_AND_GRADS = "fp16_master_weights_and_grads"
FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT = False
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"  # the reference accepts both spellings

# curriculum learning and progressive layer drop (JAX runtime/constants.py:247-260)
CURRICULUM_LEARNING = "curriculum_learning"
CURRICULUM_ENABLED = "enabled"
CURRICULUM_ENABLED_DEFAULT = False
PROGRESSIVE_LAYER_DROP = "progressive_layer_drop"
PLD_ENABLED = "enabled"
PLD_ENABLED_DEFAULT = False
PLD_THETA = "theta"
PLD_THETA_DEFAULT = 1.0
PLD_GAMMA = "gamma"
PLD_GAMMA_DEFAULT = 0.001

GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
DATA_TYPES = "data_types"
GRAD_ACCUM_DTYPE = "grad_accum_dtype"
GRAD_ACCUM_DTYPE_DEFAULT = "fp32"
DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = False

ZERO_OPTIMIZATION = "zero_optimization"
# the sparse-gradient offload wire (JAX runtime/constants.py:91-97)
SPARSE_GRADIENTS = "sparse_gradients"
SPARSE_GRADIENTS_DEFAULT = False
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
SPARSE_ATTENTION = "sparse_attention"      # a dict (build_sparsity_config) or None

# checkpoint: the atomic-commit layer's retention / validation / auto-resume
CHECKPOINT = "checkpoint"
CHECKPOINT_TAG_VALIDATION = "tag_validation"
CHECKPOINT_TAG_VALIDATION_DEFAULT = "Warn"
CHECKPOINT_TAG_VALIDATION_MODES = ["Warn", "Ignore", "Fail"]
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
LOAD_UNIVERSAL_CHECKPOINT_DEFAULT = False
CHECKPOINT_KEEP_N = "keep_n"
CHECKPOINT_KEEP_N_DEFAULT = 0          # 0 = keep everything
CHECKPOINT_VERIFY = "verify"
CHECKPOINT_VERIFY_DEFAULT = "full"     # full | size | off
CHECKPOINT_VERIFY_MODES = ["full", "size", "off"]
CHECKPOINT_AUTO_RESUME = "auto_resume"
CHECKPOINT_AUTO_RESUME_DEFAULT = False
CHECKPOINT_DIR = "dir"
CHECKPOINT_DIR_DEFAULT = None
CHECKPOINT_FSYNC = "fsync"
CHECKPOINT_FSYNC_DEFAULT = True

# io_retry: the bounded backoff of checkpoint IO
IO_RETRY = "io_retry"
IO_RETRY_MAX_ATTEMPTS = "max_attempts"
IO_RETRY_MAX_ATTEMPTS_DEFAULT = 5
IO_RETRY_BASE_DELAY_S = "base_delay_s"
IO_RETRY_BASE_DELAY_S_DEFAULT = 0.05
IO_RETRY_MAX_DELAY_S = "max_delay_s"
IO_RETRY_MAX_DELAY_S_DEFAULT = 2.0
IO_RETRY_JITTER = "jitter"
IO_RETRY_JITTER_DEFAULT = 0.25
IO_RETRY_FULL_JITTER = "full_jitter"
IO_RETRY_FULL_JITTER_DEFAULT = False   # True = AWS-style uniform(0, nominal)
IO_RETRY_MAX_ELAPSED_S = "max_elapsed_s"
IO_RETRY_MAX_ELAPSED_S_DEFAULT = None  # None = no overall wall-clock cap

HEALTH_CHECK = "health_check"
HEALTH_DEFAULTS = {
    "enabled": True,
    "skip_nonfinite": True,
    "spike_window": 50,          # EMA horizon (steps) of the loss statistics
    "spike_zmax": 0.0,           # 0 = spike detection off
    "skip_on_spike": False,
    # the host escalation ladder (skip -> rewind -> abort):
    "consecutive_skip_budget": 10,  # 0 = never escalate past skipping
    "rewind_limit": 4,              # rewinds a poison episode
    "on_exhausted": "abort",
    "check_interval": 1,            # the monitor trails the device by N steps
    "history": 64,                  # the forensic ring's length (steps)
    "forensic_dir": None,           # None: checkpoint.dir, else the working directory
}
HEALTH_ON_EXHAUSTED_MODES = ["abort", "warn"]
# the environment override of health_check.enabled (set by the launcher's --health-check)
HEALTH_CHECK_ENV = "DSTPU_HEALTH_CHECK"

# Top-level keys of the JAX config surface that the port does not run yet,
# with the value that means "off".  A dict block is off when it is empty
# or only says {"enabled": false}.
UNPORTED = {
    "amp": {}, "flops_profiler": {},
    "tensorboard": {}, "monitor": {}, "analysis": {}, "pipeline": {}, "eigenvalue": {},
    "quantize_training": {}, "compile_cache": {}, "comms_compression": {}, "mesh": {},
    "sequence_parallel": {}, "elasticity": {}, "autotuning": {},
    "communication_data_type": None,
    "disable_allgather": False, "dump_state": False, "wall_clock_breakdown": False,
    "memory_breakdown": False,
}
# why a block of UNPORTED is refused, where a ROADMAP item names it
UNPORTED_WHY = {"comms_compression": "ROADMAP item 13: comms compression, the streamed "
                                    "tier's quantized layer wire among its routes"}

# aio: the NVMe tier's async-IO handles (ops/aio over csrc/aio)
AIO = "aio"
AIO_DEFAULT_DICT = {
    "block_size": 1048576,
    "queue_depth": 8,
    "thread_count": 1,
    "single_submit": False,
    "overlap_events": True,
}
