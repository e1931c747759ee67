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
- ``cpu_checkpointing`` (JAX :147-158: ``save_and_offload_only_these_names(
  ["ckpt"], device -> pinned_host)``): inside a ``checkpoint``ed region
  each tensor marked ``checkpoint_name(x, "ckpt")`` is copied to host
  memory (pinned on a card) during the forward and brought back for the
  backward, and the recompute does not re-run the ops that only feed the
  mark, as XLA prunes them.  torch's eager recompute reruns the whole
  region, so this path is a non-reentrant checkpoint of its own
  (:func:`_host_checkpoint`, built as ``torch.utils.checkpoint``'s:
  saved-tensor hooks that keep nothing in the forward and recompute on the
  first unpack, stopping after the last saved tensor): a dispatch mode
  records the forward's ops, which tensor each op consumes and the
  storages autograd saves; an op "only feeds the mark" when every path
  from its output (through view ops) ends at the mark or at another such
  op, and it is pruned when its output is either the mark's value (the
  producer of the mark: the host copy stands in for it) or saved by
  nothing.  The recompute's dispatch mode returns, for a pruned op, the
  uploaded host copy or an empty tensor whose values no one reads, and
  runs every other op.  No other tensor is saved.  No JAX model marks
  ``ckpt``; the mark is user-facing API (:func:`checkpoint_name`).
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
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_leaves as _pt_leaves
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
# the name cpu_checkpointing offloads (JAX: names_which_can_be_offloaded=["ckpt"])
CKPT = "ckpt"
# the name checkpoint_name is marking while its alias op runs
_MARKING = threading.local()


def checkpoint_name(x, name):
    """``x`` marked ``name`` (JAX ``checkpoint_name``): an alias of ``x``
    (no copy) whose op a dispatch mode can recognise (GPT-2's ``names:``
    remat policy, :func:`checkpoint` under ``cpu_checkpointing`` for
    ``"ckpt"``); the same values either way."""
    _MARKING.name = name
    try:
        return torch.ops.aten.alias.default(x)
    finally:
        _MARKING.name = None


def marking():
    """The name :func:`checkpoint_name` is marking now, or None."""
    return getattr(_MARKING, "name", None)


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
    (JAX :137-155); under ``cpu_checkpointing`` the tensors marked
    ``"ckpt"`` are kept on the host and their producers not recomputed."""
    if CPU_CHECKPOINT:
        return _host_checkpoint(function, *args)
    return _torch_checkpoint(function, *args, use_reentrant=False, preserve_rng_state=False)


def _storage(t):
    return t.untyped_storage().data_ptr() if t.numel() else None


class _Region:
    """One region's forward record: each op, its consumers (by tensor
    identity: the outputs are held until the forward ends, so ids are
    unique), the storages autograd saved, the mark and its host copies."""

    def __init__(self):
        self.ops, self.cons, self.keep = [], [], []
        self.owner = {}           # id(output tensor) -> op index
        self.made = {}            # storage -> indices of the ops whose outputs use it
        self.saved = set()        # storages autograd saved
        self.opaque = set()       # ops with a consumer not told apart (never pruned)
        self.marks = {}           # mark op index -> its host copy
        self.pruned = {}          # op index -> substitute maker
        self.n_saved = 0
        self.values = None        # the recompute's saved tensors
        self.cursor = 0

    def record(self, func, args, kwargs, out, marked):
        i = len(self.ops)
        for t in _pt_leaves((args, kwargs)):
            if not isinstance(t, torch.Tensor):
                continue
            j = self.owner.get(id(t))
            if j is not None:
                self.cons[j].append(i)
            else:
                # a tensor of this region's storage whose object is not an output seen
                # here: its producers count as having an unknown consumer
                self.opaque.update(self.made.get(_storage(t), ()))
        outs = [t for t in _pt_leaves(out) if isinstance(t, torch.Tensor)]
        one = isinstance(out, torch.Tensor) and len(outs) == 1
        self.ops.append((func, one, tuple(out.shape) if one else None,
                         one and out.is_contiguous(), out.dtype if one else None,
                         out.device if one else None))
        self.cons.append([])
        for t in outs:
            self.owner[id(t)] = i
            self.keep.append(t)
            self.made.setdefault(_storage(t), []).append(i)
        if marked:
            pin = out.device.type == "cuda"
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=pin)
            host.copy_(out, non_blocking=pin)
            self.marks[i] = host

    def analyse(self):
        """The ops to prune, in reverse order: a non-view, single-output,
        non-mutating op whose every consumer path (through views) ends at
        a mark or a pruned op, and whose output is the mark's value (a
        chain of contiguous reshapes to the mark) or saved by nothing."""
        saved = {i for s in self.saved for i in self.made.get(s, ())}

        def ends_ok(c):
            if c in self.marks or c in self.pruned:
                return True
            func = self.ops[c][0]
            return (func.is_view and c not in self.opaque and bool(self.cons[c])
                    and all(ends_ok(d) for d in self.cons[c]))

        def mark_value(i):
            # i -> contiguous reshapes (one consumer each) -> a mark
            n = None
            while True:
                _, single, shape, contiguous, _, _ = self.ops[i]
                if not (single and contiguous):
                    return None
                count = 1
                for d in shape:
                    count *= d
                n = count if n is None else n
                if count != n or len(self.cons[i]) != 1:
                    return None
                c = self.cons[i][0]
                if c in self.marks:
                    return self.marks[c]
                if not self.ops[c][0].is_view:
                    return None
                i = c

        for i in range(len(self.ops) - 1, -1, -1):
            func, single, shape = self.ops[i][:3]
            if (func.is_view or not single or func._schema.is_mutable or i in self.opaque
                    or i in self.marks or not self.cons[i]
                    or not all(ends_ok(c) for c in self.cons[i])):
                continue
            host = mark_value(i)
            if host is not None:
                self.pruned[i] = host.reshape(shape)
            elif i not in saved:
                self.pruned[i] = None
        self.owner, self.keep, self.made = {}, [], {}

    def substitute(self, i):
        """What the recompute returns for the pruned op ``i``: the mark's
        host copy on the op's device, or an empty tensor no one reads."""
        _, _, shape, _, dtype, device = self.ops[i]
        host = self.pruned[i]
        if host is None:
            return torch.empty(shape, dtype=dtype, device=device)
        if host.device == device:
            return host.clone()
        return host.to(device, non_blocking=True)


_DETACH = torch.ops.aten.detach.default


class _Tape(TorchDispatchMode):
    """The forward's dispatch mode: records each op (and offloads marks)."""

    def __init__(self, region):
        super().__init__()
        self.region = region

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        marked = func is torch.ops.aten.alias.default and marking() == CKPT
        out = func(*args, **kwargs)
        if func is not _DETACH:      # the forward's dispatcher adds some the recompute lacks
            self.region.record(func, args, kwargs, out, marked)
        return out


class _Replay(TorchDispatchMode):
    """The recompute's dispatch mode: the pruned ops return their
    substitutes, the others run."""

    def __init__(self, region):
        super().__init__()
        self.region = region

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        r = self.region
        if func is _DETACH:
            return func(*args, **(kwargs or {}))
        i, r.cursor = r.cursor, r.cursor + 1
        if i >= len(r.ops) or r.ops[i][0] is not func:
            raise RuntimeError(f"cpu_checkpointing: the recompute diverged from the forward at "
                               f"op {i} ({func}); a checkpointed region must run the same ops "
                               "each time")
        if i in r.pruned:
            last_stats["skipped"] += 1
            with _disable_current_modes():      # the machinery's own copy, not the region's
                return r.substitute(i)
        return func(*args, **(kwargs or {}))


class _StopRecompute(Exception):
    pass


def _host_checkpoint(fn, *args):
    """``fn(*args)`` under ``cpu_checkpointing`` (see the module docstring).
    Forward: saved-tensor hooks keep an index in place of each saved
    tensor, :class:`_Tape` records the ops.  The first unpack in the
    backward recomputes the region under :class:`_Replay`, collecting the
    saved tensors in order, and stops after the last one."""
    region = _Region()

    def pack(t):
        region.saved.add(_storage(t))
        region.n_saved += 1
        return region.n_saved - 1

    def unpack(k):
        if region.values is None:
            region.values, region.cursor = [], 0
            inputs = [a.detach().requires_grad_(a.requires_grad) if isinstance(a, torch.Tensor)
                      else a for a in args]

            def pack2(t):
                if t.requires_grad:
                    with _disable_current_modes():     # the machinery's, not the region's op
                        t = t.detach()
                region.values.append(t)
                if len(region.values) == region.n_saved:
                    raise _StopRecompute
                return None
            try:
                with torch.autograd.graph.saved_tensors_hooks(pack2, lambda _: None), \
                        torch.enable_grad(), _Replay(region):
                    fn(*inputs)
            except _StopRecompute:
                pass
        return region.values[k]

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        with _Tape(region):
            out = fn(*args)
    region.analyse()
    last_stats.update(ops=len(region.ops), pruned=[str(region.ops[i][0]) for i in
                                                   sorted(region.pruned)],
                      marks=list(region.marks.values()), skipped=0)
    return out


# the last region of _host_checkpoint: its forward's op count, the ops its
# recompute prunes, the marks' host copies, and the ops the recompute skipped
last_stats = {}


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
    if CONTIGUOUS_CHECKPOINTING:
        assert PARTITION_ACTIVATIONS, \
            "Contiguous Checkpointing is only available with partitioned activations."
        assert num_layers is not None, \
            "Must specify the number of layers with contiguous memory checkpointing"


def is_configured():
    return _enabled
