"""Activation checkpointing over ``torch.utils.checkpoint``.

Counterpart of
``deepspeed_tpu/runtime/activation_checkpointing/checkpointing.py`` (242
lines): ``checkpoint``, ``checkpoint_wrapper``, ``configure``,
``is_configured``, ``reset``, ``set_num_layers``,
``partition_activations_in_checkpoint``, ``RNGStatesTracker``,
``get_rng_tracker`` and ``model_parallel_seed`` (with the reference's
``get_cuda_rng_tracker`` / ``model_parallel_cuda_manual_seed`` names),
and the module switches ``configure`` sets from the config's
``activation_checkpointing`` block.

- ``checkpoint(fn, *args)`` is ``torch.utils.checkpoint.checkpoint(fn,
  *args, use_reentrant=False, preserve_rng_state=False)``: the region's
  activations are recomputed in the backward, and the call may be
  captured in a CUDA graph, as the port's GPT-2 and BERT blocks are
  (``models/gpt2.py``, ``models/bert.py``).  No RNG state is saved: the
  port's dropout draws from seeds hashed from (seed, path)
  (``runtime/step_graph.py``), never from the CUDA generator, so a
  recompute draws the same masks.
- ``cpu_checkpointing`` is not ported: ``configure`` raises
  ``NotImplementedError`` when it is on.  JAX's meaning
  (``save_and_offload_only_these_names(names_which_can_be_offloaded=
  ["ckpt"])``) keeps the tensors marked ``ckpt`` in host memory and
  drops the ops that produce them from the recompute, which XLA prunes;
  torch's eager recompute reruns the whole region, producers included,
  so host copies of the marked tensors would add two copies each and
  save no work (ROADMAP item 3).
- ``partition_activations`` shards the saved inputs over the ``tensor``
  axis in JAX; at world size 1 that axis has size 1 and JAX leaves them
  whole, as the port does.
- ``contiguous_memory_optimization``, ``synchronize`` and ``profile`` are
  stored, as in JAX, and change nothing.

The RNG tracker holds explicit ``torch.Generator`` seeds by name; ``fork``
yields a generator seeded with a splitmix64 fold of the stream's seed and
its fork count (JAX yields ``fold_in(key, count)``).
"""

import contextlib

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

from ...utils.logging import logger
from ..step_graph import fold

# module configuration (JAX :41-49)
_enabled = False
mpu = None
num_layers = None
PARTITION_ACTIVATIONS = False
CPU_CHECKPOINT = False
CONTIGUOUS_CHECKPOINTING = False
SYNCHRONIZE = False
PROFILE_TIME = False
CPU_CHECKPOINT_ERROR = ("activation_checkpointing.cpu_checkpointing is not ported: torch's "
                        "eager recompute reruns the ops that produce the tensors marked "
                        "'ckpt', so keeping them in host memory would save no recompute "
                        "(ROADMAP item 3)")


# ------------------------------------------------------------ rng tracker
class RNGStatesTracker:
    """Named seed streams (JAX :53-92, the reference's
    ``CudaRNGStatesTracker``)."""

    def __init__(self):
        self.states_ = {}

    def reset(self):
        self.states_ = {}

    def get_states(self):
        return dict(self.states_)

    def set_states(self, states):
        self.states_ = dict(states)

    def add(self, name, seed):
        if name in self.states_:
            raise Exception(f"seed {name} already exists")
        for existing in self.states_.values():
            if int(existing[1]) == int(seed):
                raise Exception(f"seed {seed} already exists")
        self.states_[name] = [torch.Generator().manual_seed(int(seed)), int(seed), 0]

    @contextlib.contextmanager
    def fork(self, name="model-parallel-rng", device="cpu"):
        """Yields a fresh ``torch.Generator`` on ``device`` from the named
        stream: seeded with the fold of its seed and fork count."""
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        gen, seed, count = self.states_[name]
        self.states_[name] = [gen, seed, count + 1]
        yield torch.Generator(device=device).manual_seed(fold(seed, count))


_RNG_TRACKER = RNGStatesTracker()


def get_rng_tracker():
    """The module's tracker (the reference's ``get_cuda_rng_tracker``)."""
    return _RNG_TRACKER


get_cuda_rng_tracker = get_rng_tracker


def model_parallel_seed(seed, tensor_axis_index: int = 0):
    """The data-parallel stream gets ``seed``, the model-parallel stream
    ``seed + 2718 + tensor_axis_index`` (JAX :107-112)."""
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("data-parallel-rng", seed)
    _RNG_TRACKER.add("model-parallel-rng", seed + 2718 + tensor_axis_index)


model_parallel_cuda_manual_seed = model_parallel_seed


# ------------------------------------------------------------- checkpoint
def checkpoint(function, *args):
    """``function(*args)`` with its activations recomputed in the backward
    (JAX :137-155)."""
    return _torch_checkpoint(function, *args, use_reentrant=False, preserve_rng_state=False)


def checkpoint_wrapper(function):
    """The decorator form layer libraries use."""
    def wrapped(*args):
        return checkpoint(function, *args)
    return wrapped


# ----------------------------------------------------------- configuration
def partition_activations_in_checkpoint(partition_activation):
    global PARTITION_ACTIVATIONS
    PARTITION_ACTIVATIONS = partition_activation
    logger.info(f"**************Partition Activations {PARTITION_ACTIVATIONS}************")


def set_num_layers(nlayers):
    global num_layers
    num_layers = nlayers


def reset():
    """Nothing to free: no contiguous buffers are kept (JAX :177-178)."""


def _configure_defaults():
    global PARTITION_ACTIVATIONS, CONTIGUOUS_CHECKPOINTING, num_layers, \
        CPU_CHECKPOINT, SYNCHRONIZE, PROFILE_TIME, _enabled
    PARTITION_ACTIVATIONS = False
    CONTIGUOUS_CHECKPOINTING = False
    num_layers = None
    CPU_CHECKPOINT = False
    SYNCHRONIZE = False
    PROFILE_TIME = False
    _enabled = True


def _configure_using_config_file(config, mpu=None):
    from ..config import DeepSpeedConfig
    global PARTITION_ACTIVATIONS, CONTIGUOUS_CHECKPOINTING, num_layers, \
        CPU_CHECKPOINT, SYNCHRONIZE, PROFILE_TIME
    c = DeepSpeedConfig(config).activation_checkpointing
    PARTITION_ACTIVATIONS = c.partition_activations
    CONTIGUOUS_CHECKPOINTING = c.contiguous_memory_optimization
    num_layers = c.number_checkpoints
    CPU_CHECKPOINT = c.cpu_checkpointing
    SYNCHRONIZE = c.synchronize_checkpoint_boundary
    PROFILE_TIME = c.profile


def configure(mpu_=None, deepspeed_config=None, partition_activations=None,
              contiguous_checkpointing=None, num_checkpoints=None,
              checkpoint_in_cpu=None, synchronize=None, profile=None):
    """The reference's argument surface (JAX :212-237)."""
    global mpu, num_layers, PARTITION_ACTIVATIONS, CONTIGUOUS_CHECKPOINTING, \
        CPU_CHECKPOINT, SYNCHRONIZE, PROFILE_TIME
    _configure_defaults()
    if mpu_ is not None:
        mpu = mpu_
    if deepspeed_config is not None:
        _configure_using_config_file(deepspeed_config, mpu=mpu)
    if partition_activations is not None:
        PARTITION_ACTIVATIONS = partition_activations
    if contiguous_checkpointing is not None:
        CONTIGUOUS_CHECKPOINTING = contiguous_checkpointing
    if num_checkpoints is not None:
        num_layers = num_checkpoints
    if checkpoint_in_cpu is not None:
        CPU_CHECKPOINT = checkpoint_in_cpu
    if synchronize is not None:
        SYNCHRONIZE = synchronize
    if profile is not None:
        PROFILE_TIME = profile
    if CPU_CHECKPOINT:
        CPU_CHECKPOINT = False
        raise NotImplementedError(CPU_CHECKPOINT_ERROR)
    if CONTIGUOUS_CHECKPOINTING:
        assert PARTITION_ACTIVATIONS, \
            "Contiguous Checkpointing is only available with partitioned activations."
        assert num_layers is not None, \
            "Must specify the number of layers with contiguous memory checkpointing"


def is_configured():
    return _enabled
