"""Checkpoint key constants.

Counterpart of ``deepspeed_tpu/checkpoint/constants.py``, copied key for
key: the two packages read and write the same meta keys, tree keys and
file names, so a checkpoint written by one loads in the other.
"""

# engine-level meta keys (stored in model_states meta.json)
DS_VERSION = "ds_version"
GLOBAL_STEPS = "global_steps"
OPTIMIZER_STEPS = "optimizer_steps"
SKIPPED_STEPS = "skipped_steps"
MICRO_STEPS = "micro_steps"
GLOBAL_SAMPLES = "global_samples"
ZERO_STAGE = "zero_stage"
DTYPE = "dtype"
CLIENT_STATE = "client_state"
LR_SCHEDULER = "lr_scheduler"

# optimizer file tree keys
OPTIMIZER_STATE_DICT = "opt_state"
FP32_MASTER = "master"
LOSS_SCALE_STATE = "scale"

# reference keys kept for tool compatibility
FP32_FLAT_GROUPS = "fp32_flat_groups"
SINGLE_PARTITION_OF_FP32_GROUPS = "single_partition_of_fp32_groups"
PARTITION_COUNT = "partition_count"
PARAM_SHAPES = "param_shapes"
BUFFER_NAMES = "buffer_names"

# file names (engine layout)
MODEL_FILE = "model_states.msgpack"
OPTIM_FILE = "optim_states.msgpack"
LATEST_FILE = "latest"
