"""DeepSpeedEngine: the training loop wrapper, single-device fused path.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``).
Ported: ``_resolve_model``'s parameter source (``params=``, else the
model's own initialiser), ``_configure_optimizer`` (Adam, AdamW, Lamb,
SGD),
``_configure_lr_scheduler``,
``_init_state`` (compute-dtype params, fp32 master, fp32 Adam moments,
step counters, the fp16 loss scaler's state), ``_grad_fn`` (gradient
accumulation in fp32 — or bf16 with ``data_types.grad_accum_dtype`` — of
``loss * cur_scale / gas``), ``_grads_and_metrics`` (unscale and the
overflow scan in fp16, clip by global norm), ``_health_sentinels``,
``_train_step`` with the branchless skip-step and the loss-scale tick,
``train_batch``,
``_stack_microbatches``, ``_finish_step``, ``eval_batch``, the
accessors, and checkpoints (JAX :2154-2628): ``save_checkpoint``,
``save_16bit_model``, ``_copy_recovery_script``,
``_resolve_checkpoint_tag``, ``_check_mesh_transition`` and
``load_checkpoint``, in the JAX package's container and layout
(``checkpoint/``), so either package loads the other's checkpoints.
``train_batch`` visits ``fault.site("engine.step")``, counts the
monotonic data-stream index ``_stream_step`` and passes the host
micro-batches through ``fault.corrupt_batch`` (JAX :1409-1430).

The health guardian's host ladder (JAX :181-194, :1594-1598,
:1733-1853): with ``health_check.enabled`` (the default) the engine
builds a ``HealthMonitor`` and feeds it each step's metrics after
``train_batch`` and after a boundary ``step()`` (``_health_observe``);
the monitor reads them ``check_interval`` steps later (the metrics are
clones of the step's outputs, so a later replay does not overwrite
them).  A run of ``consecutive_skip_budget`` skipped steps rewinds in
process (``_health_rewind`` → :meth:`rewind`): ``load_checkpoint`` of
the newest valid tag under ``checkpoint.dir`` (or the last directory
saved to or loaded from), then the data stream fast-forwarded past the
last poisoned batch, by an O(1) jump of the loader's ``(epoch,
batch_index)`` where the engine owns a ``RepeatingLoader`` over a
``DeepSpeedDataLoader``, else batch by batch; a rewind that runs straight
back into skips doubles the stride.  ``rewind_limit`` spent rewinds, or
a rewind that cannot run (no checkpoint directory), end in
``on_exhausted``: ``TrainingHealthError`` with a forensic JSON file
(``_health_abort``), or a warning.  Every state a rewind restores is
restored in place (``load_checkpoint``), so the captured step graphs
stay valid; ``save_checkpoint`` flushes the monitor's lag window, and
``load_checkpoint`` drops a pending DPU step, resets the monitor's
consecutive count and pending entries, and restores the stream position.

As in the JAX engine, gradients are taken with respect to the fp32
master through its cast to the compute dtype (``_micro_loss_fn``), and a
step whose loss, gradients or updated parameters are non-finite (or
whose loss spikes, with ``skip_on_spike``) is a ``torch.where`` no-op on
the master, the parameters and the optimizer state: the skip flag stays
on the device, so the step needs no host sync, and ``optimizer_steps``
(Adam's bias-correction step) does not advance on a skip.

fp16 (``"fp16": {"enabled": true}``, JAX :614-645, :915-931, :1068-1113,
:1115-1137, :1175-1199): fp16 params, the fp32 master and fp32 optimizer
state; each micro-batch's loss is scaled by the scaler's ``cur_scale`` (a
0-d device tensor, ``runtime/fp16/loss_scaler.py``), the fp32 gradients
are divided by it and scanned once for inf / NaN (``overflow``); an
overflow skips the step whether or not the health guardian is on, the
guardian's ``nonfinite_grads`` reuses the scan, and the scaler ticks on
``overflow`` alone (never on a health skip), in place and gated by
``commit`` like the health EMA.  The metrics gain ``overflow`` and
``loss_scale`` (the scale the step used).  Gradients stay fp32.

The step (JAX's jitted, donated ``train_step``, :451-455 and
:1138-1221) is one CUDA graph on the card: ``train_batch`` runs
``_train_step`` through a :class:`~.step_graph.StepGraph` per (micro-batch
leaf shapes and dtypes, gas; ``_step_for``) on the engine's own
``GraphPool``, so every
micro-batch's forward and backward, the accumulation, the clip, the
health sentinels, the optimizer update and the commit are one replay.
Its inputs are static buffers refilled from pinned staging before each
replay: the stacked ``(gas, micro, ...)`` batch leaves, the lr (a 0-d
fp32 device tensor, filled from the host ``lr_fn``; the host float stays
in the metrics) and ``commit``, a 0-d flag that is False during the
warm-up and the capture, which run the body once each on the static
values, and True on every real call: it gates the base, the optimizer
state, the health EMA and both step counters exactly as a skip does, so
neither trains.  Dropout seeds reach the body as a ``FoldedSeed`` and are
re-seeded before each replay (``runtime/step_graph.py``).  The state is
updated in place (the EMA too), so the captured addresses stay valid;
``train_batch`` returns a clone of the step's loss and keeps clones in
the metrics.  ``step_impl`` (``DeepSpeedEngine`` / ``initialize``):
"auto" resolves to "graph", which is a capture on CUDA and a direct call
of the same body on the CPU; "eager" calls that body directly on the card
too (the A/B path).  A capture or replay that fails raises naming the
step; a ``loss_fn`` that reads a device value back to the host cannot be
captured (``StepGraph`` refuses it during capture) and needs "eager".
Nothing falls back to eager.  What stays on the host each step: drawing
the micro-batches, ``fault.site`` / ``fault.corrupt_batch``, the lr
schedule, the seed folds, the staging copies and the counters' host
mirrors.

Other deliberate differences: the engine runs on the model's device (ZeRO
stages 0-2 share the single-device placement); the lr schedules are pure
functions of the host step counter; dropout seeds are integers folded
from ``(rng_seed, micro_steps, microbatch)`` with splitmix64, not PRNG
keys.
``load_checkpoint`` copies every leaf into the engine's existing
tensors (``copy_``), so their addresses, and the captured graphs, stay
valid; the device step counters are filled in place and the health EMA
zeroed in place (JAX re-initialises it, :2583-2588); an fp16 engine saves
its scaler state as the ``scale`` optimizer tree (JAX :2251) and loads it
in place, and any other engine ignores a ``scale`` tree (JAX :2525-2549).
A checkpoint holds one device's full arrays, and its meta records JAX's
1-device mesh
(:data:`ONE_DEVICE_MESH`); a checkpoint from a larger mesh loads with
JAX's warning when the global batch changed (``elasticity``, under which
JAX raises there, is refused by the port's config).  What the port does
not run raises ``NotImplementedError`` naming the key: any optimizer tree
but ``opt_state`` / ``master`` / ``scale`` / ``comm_error`` (ignored, as
JAX ignores it in an engine without error feedback).

The imperative API (JAX :1964-1998): ``forward(batch)`` stages the
micro-batch and returns ``eval_batch``'s loss, ``backward()`` queues it,
and ``step()`` runs, at the accumulation boundary
(``is_gradient_accumulation_boundary``), the same captured step that
``train_batch`` runs, over the queued micro-batches (``_run_step``): the
same graph, seed fold and lr, so the two APIs give the same losses bit
for bit; before the boundary it returns None.  As in JAX, only
``train_batch`` visits the fault sites and applies the curriculum.

Curriculum learning (``"curriculum_learning"``, JAX :461-464,
:1432-1462): ``runtime/data_pipeline/curriculum_scheduler.py`` sets the
difficulty of step ``global_steps + 1`` and ``train_batch`` crops each
host micro-batch to it along axis 1 (integer leaves to ``seqlen + 1``
tokens, the rest to ``seqlen``) before stacking.  Each difficulty is a new
micro-batch shape and so a new step graph (the JAX step retraces).  Held,
the graphs of the past difficulties pin memory that grows with each one
(their pool's blocks are too small for the longer shapes; PERF.md section
6, PR 25), and a curriculum never returns to a shorter length: when the
difficulty moves on they are released (``_release_graphs``,
``StepGraph.release``), the next capture takes a new pool (a private pool
whose last graph is freed takes no capture) and the freed segments go
back to the driver; ``stats()["graphs"]`` keeps counting them
(``released``).  Progressive
layer drop (``"progressive_layer_drop"``, JAX :465-470, :1573-1574):
``runtime/progressive_layer_drop.py``'s theta is updated after each step
and read with ``progressive_layer_drop.get_state()``; no model reads it.

Client objects (JAX :516-524, :566-579): ``optimizer=`` takes the
port's own ``FusedAdam`` / ``FusedAdamW`` / ``FusedLamb`` / ``SGD`` /
``DeepSpeedCPUAdagrad`` (their ``init`` / ``update`` run inside the
captured step), ``lr_scheduler=`` an object with ``lr_fn(step)`` and
``step()`` (the port's ``lr_schedules`` classes); the lr stays the step's
0-d input, filled from the host each step.  Any other object raises
``TypeError`` naming itself: nothing falls back.

ZeRO-Offload (``zero_optimization.offload_optimizer: {"device": "cpu"}``,
JAX :333-406, :1224-1286, :1337-1420, :1493-1526, :1856-1913,
:1927-1941), at any stage (stage 3's placement on one device is stage
0's).  The device holds the compute-dtype params and no fp32 master or
moments (``master`` and ``opt_state`` are None); the host holds them in
``runtime/zero/offload_engine.py``.  A step is two halves.  The device
half (``_grad_only_step``) is the captured ``StepGraph``: gradients of
the params, unscaled, clipped and flattened into one static buffer (bf16
under bf16, fp32 otherwise, as JAX keeps them), the loss scale and the
health EMA advanced in the graph under ``commit``, and the unified
``skip``.  The host half (``_host_offload_update``) lands the d2h of that
buffer (and of ``skip``) on a copy stream, runs the native host Adam (or,
on a skip, touches nothing on the host) and uploads the payload image
on the copy stream into a second device buffer, which is copied into the
params on the compute stream, behind the replays queued there, so an
upload never writes the params a replay reads.  With
``delayed_param_update`` (DPU), from step ``delayed_param_update_warmup``
on the host half of step k runs after the replay of step k+1 is queued:
that replay reads the params of step k-1's update (one step stale), the
gradients it writes are first copied to a staging buffer on the device
(so the next replay never overwrites a buffer whose d2h is in flight),
and the pending step is applied by ``_flush_offload`` before
``save_checkpoint``, ``save_16bit_model``, ``eval_batch`` and
``offload_state``.  The pending step's host work (landing, widening, the
native Adam: ``_host_offload_compute``) runs on a worker thread started
before the replay, because a replay holds its calling thread until most
of its launches have run (PERF.md section 6, PR 26); its stream work (the
upload and the copy into the params: ``_host_offload_finish``) stays on
the calling thread.  The host reads no device value of a step but
through the landed copies.
Checkpoints carry the host master and moments in the in-device layout.
The client optimizer under offload raises JAX's ``ValueError``.  As in
JAX, health's ``skip_nonfinite`` checks the gradients and the loss there,
not the updated params (the host updates them); the engine logs so.
Difference: the lr of step k is ``lr_fn(k)`` under DPU too (JAX reads its
device step counter, which lags by the pending step there).

The NVMe tier (``offload_optimizer: {"device": "nvme", "nvme_path":
...}``, JAX :333-406): the host tier with its Adam moments in swap files
(``runtime/zero/offload_engine.py`` over ``runtime/swap_tensor`` and
``ops/aio``), built with the ``aio`` block's handles and the
``io_retry`` policy; the step, DPU's worker thread and checkpoints go
through the swap files, and checkpoints keep the in-device layout.

ZeRO-3 parameter offload (``zero_optimization.offload_param: {"device":
"cpu" | "nvme"}``, JAX :227-268, :348-392, :1532-1563): the model's
parameters live in the host tier only, built over the layer-major stream
tree (``runtime/zero/param_stream.py``'s ``to_stream_tree``, the init tree
consumed leaf by leaf), and ``ParamStreamRunner`` streams the layer blocks
through the card each step (``_run_stream_step``; ``params``, ``master``,
``opt_state`` and ``health`` are None, the metrics are host values).
JAX's validation and ``ValueError`` texts: stage 3, an
``offload_optimizer`` with a config Adam/AdamW, no fp16, a model with
``stream_fns``, ``fast_init`` only with ``init_numpy``.  The step is a
Python loop over per-layer work, as JAX's is a loop over per-layer jits:
``step_impl`` "auto" runs it eagerly and "graph" raises.  As in JAX,
``delayed_param_update`` has no effect there (the step runs
synchronously; logged once).  ``eval_batch``, ``module_state_dict``,
``save_16bit_model`` and checkpoints go through the host tier in the
stacked model layout (``from_stream_tree`` / ``to_stream_tree``), so
streamed and monolithic checkpoints load into each other;
``load_checkpoint`` refreshes the NVMe layer files and the card's
nonblock params (``reload_from_host``) and resets the runner's host EMA.

The sparse-gradient wire (``sparse_gradients``, JAX :413-432, :1271-1340,
:1856-1941): with the host tier, the leaves the model declares in
``sparse_grad_paths()`` (lookup tables only) leave the captured grad step
as ``SparseTensor.from_dense``'s first ``k`` nonzero rows (indices and
values, ``runtime/sparse_tensor.py``; ``k`` the model's
``sparse_grad_row_bound(batch)`` or the batch's integer id count, static),
beside the dense buffer of the other leaves; the host scatters them
through ``HostOffloadOptimizer.flatten_grads``.  The rows beyond the bound
are counted on the card (``sparse_rows_dropped``); the counts of applied
steps are read at reporting steps, every 50 steps and at every flush
(``_flush_row_drop_checks``), and a nonzero count raises
``RuntimeError``.  Without declared paths JAX's warning is logged and the
gradients stay dense.  Difference: the upload stays one flat copy (JAX
uploads a tree under the sparse wire, with DPU's alternating staging
trees; the port's stage and its events already keep an upload off the
image the next host step writes).

Not ported: ZeRO across ranks, monitoring (the config raises for each)
and the 1-bit optimizers.
"""

import time

import json
import os
import shutil

import numpy as np
import torch

from .. import fault
from ..checkpoint import atomic
from ..checkpoint.constants import MODEL_FILE, OPTIM_FILE
from ..checkpoint.serialization import load_tree, restore_like, save_tree
from .config import DeepSpeedConfig
from . import health as hmod
from .data_pipeline.curriculum_scheduler import CurriculumScheduler
from .progressive_layer_drop import ProgressiveLayerDrop
from .fp16 import loss_scaler as ls
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .lr_schedules import get_lr_scheduler
from .step_graph import GraphPool, StepGraph, fold as _fold
from .utils import (DummyOptim, clip_by_global_norm, global_norm, tree_cast,
                    tree_leaves, tree_map)
from ..ops.adagrad.cpu_adagrad import DeepSpeedCPUAdagrad
from ..ops.adam.fused_adam import FusedAdam, FusedAdamW
from ..ops.lamb.fused_lamb import FusedLamb
from ..ops.sgd import SGD
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger

# the mesh record of a checkpoint saved on one device, as the JAX engine
# writes it for its 1-device mesh (the axes of parallel/mesh.py)
ONE_DEVICE_MESH = {"pipe": 1, "data": 1, "fsdp": 1, "expert": 1, "seq": 1, "tensor": 1}
# optimizer-file trees the port loads (comm_error is ignored, see load_checkpoint)
OPTIM_TREES = ("opt_state", "master", "scale", "comm_error")
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                  "float32": torch.float32}
STEP_IMPLS = ("auto", "graph", "eager")
CAPTURE_HINT = ("a loss_fn that reads a device value back to the host cannot be captured; "
                "train it with step_impl='eager'")
# the optimizer objects the captured step runs (a client optimizer must be one)
CAPTURED_OPTIMIZERS = (FusedAdam, FusedLamb, SGD, DeepSpeedCPUAdagrad)
STREAM_GRAPH_ERROR = ("step_impl='graph' cannot capture the streamed step of offload_param: "
                      "it is a host loop of per-layer uploads, blocks, gradient landings and "
                      "a host optimizer step; use step_impl='auto' or 'eager'")
OFFLOAD_CLIENT_ERROR = ("offload_optimizer requires a config-specified Adam/AdamW (the host "
                        "tier runs its own fused step; a client optimizer object cannot be "
                        "offloaded)")


def _named_leaves(tree, prefix="batch"):
    """``{name: leaf}`` over a tree's leaves, names its dict keys and
    sequence indices joined with ``/``."""
    if isinstance(tree, dict):
        return {n: l for k in tree for n, l in _named_leaves(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {n: l for i, t in enumerate(tree)
                for n, l in _named_leaves(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _like(template, named, prefix="batch"):
    """The inverse of :func:`_named_leaves`: ``template``'s structure with
    its leaves taken from ``named``."""
    if isinstance(template, dict):
        return {k: _like(v, named, f"{prefix}/{k}") for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        items = [_like(t, named, f"{prefix}/{i}") for i, t in enumerate(template)]
        return type(template)(*items) if hasattr(template, "_fields") else type(template)(items)
    return named[prefix]


def _to_master(params, device):
    """Params (numpy arrays or tensors) → owned fp32 tensors on ``device``."""
    def conv(a):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=device, dtype=torch.float32, copy=True)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return tree_map(conv, params)


class DeepSpeedEngine:
    """Config-driven training engine over one device.

    Pass ``model`` (with ``.loss(params, batch, rng)``; the engine runs on
    ``model.device``) or ``loss_fn`` + ``params`` (then ``device``, which
    defaults to CUDA and raises without a card).  Without ``params`` the
    engine takes ``model.init_numpy(rng_seed)`` (GPT-2) or, as the JAX
    engine's ``_resolve_model`` does, ``model.init(rng_seed)`` (BERT).
    ``step_impl``: "auto" / "graph" (the step captured on CUDA, called
    directly on the CPU) or "eager" (called directly on the card too)."""

    def __init__(self, model=None, config=None, training_data=None, loss_fn=None,
                 params=None, rng_seed=0, device=None, step_impl="auto", optimizer=None,
                 lr_scheduler=None, collate_fn=None):
        if config is None:
            raise ValueError("DeepSpeed requires a config (dict or JSON path)")
        self.config = DeepSpeedConfig(config)
        self.module = model
        if device is None and model is not None and hasattr(model, "device"):
            device = model.device
        self.device = resolve_device(device)
        if model is not None and getattr(model, "device", self.device) != self.device:
            raise ValueError(f"device {self.device} differs from the model's "
                             f"{model.device}")
        self._streamed = self._check_param_stream(model, optimizer, params)
        if loss_fn is None:
            if model is None or not hasattr(model, "loss"):
                raise ValueError("Provide model= (with .loss) or loss_fn= and params=")
            loss_fn = model.loss
        if params is None:
            if model is not None and hasattr(model, "init_numpy"):
                params = model.init_numpy(rng_seed)
            elif model is not None and hasattr(model, "init"):
                params = model.init(rng_seed)     # as _resolve_model (engine.py:110-112)
            else:
                raise ValueError("Provide params= or a model with .init_numpy(seed) "
                                 "or .init(seed)")
        self._loss_fn = loss_fn
        if step_impl not in STEP_IMPLS:
            raise ValueError(f"step_impl must be one of {STEP_IMPLS}, got {step_impl!r}")
        if self._streamed and step_impl == "graph":
            raise ValueError(STREAM_GRAPH_ERROR)
        self.step_impl = "eager" if step_impl == "eager" or self._streamed else "graph"
        self._graphs = None                 # the step graphs' GraphPool, made at first use
        self._steps = {}                    # graph key -> its StepGraph
        self._released = []                 # StepGraphs of past curriculum difficulties
        self.zero_stage = self.config.zero_optimization_stage
        self.compute_dtype = COMPUTE_DTYPES[self.config.precision_dtype]
        self._needs_master = self.compute_dtype != torch.float32
        self.fp16_enabled = self.config.fp16_enabled
        self._health_cfg = self.config.health_check
        self._health_enabled = self._health_cfg.enabled
        if self.config.noop_keys_set:
            log_dist("config keys accepted but NO-OPs on one device: "
                     + ", ".join(self.config.noop_keys_set), ranks=[0])

        self.optimizer = self._configure_optimizer(optimizer)
        self.lr_scheduler = self._configure_lr_scheduler(lr_scheduler)
        self._configure_offload(optimizer, params)
        self._init_state(None if self._offload is not None else _to_master(params, self.device))

        self.training_dataloader = None
        self._data_iterator = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data, collate_fn=collate_fn)
            self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
        self._rng_seed = int(rng_seed)
        self._stream_step = 0             # monotonic data-stream batch index
        self._last_batch_index = None     # the stream index of the running step
        # whether _stream_step and the engine's iterator agree (a rewind's
        # fast-forward needs it): lost to an external data_iter or a load
        # without the loader's state
        self._stream_pos_known = True
        self._ff_stride = 1               # a same-episode rewind's fast-forward stride
        self._last_ckpt_dir = self.config.checkpoint_config.dir
        self.health_monitor = (hmod.HealthMonitor(self._health_cfg)
                               if self._health_enabled else None)
        self._sentinel_ring, self._sentinel_slot = None, 0   # pinned copies the monitor reads
        self.loaded_checkpoint_tag = None
        self.micro_steps = 0
        self.global_samples = 0
        self._global_steps = 0
        self._last_metrics = {}
        # the imperative API's staged and queued micro-batches
        self._staged_batch = None
        self._pending_microbatches = []
        self.curriculum_scheduler = (CurriculumScheduler(self.config.curriculum.params)
                                     if self.config.curriculum.enabled else None)
        self.progressive_layer_drop = (
            ProgressiveLayerDrop(theta=self.config.pld.theta, gamma=self.config.pld.gamma)
            if self.config.pld.enabled else None)
        log_dist(f"DeepSpeedEngine ready: zero_stage={self.zero_stage} "
                 f"dtype={self.config.precision_dtype} device={self.device} "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()} step_impl={self.step_impl}",
                 ranks=[0])

    # ------------------------------------------------------------------ config
    def _configure_optimizer(self, client_optimizer=None):
        if client_optimizer is not None:
            if not isinstance(client_optimizer, CAPTURED_OPTIMIZERS):
                raise TypeError(
                    f"client optimizer {type(client_optimizer).__module__}."
                    f"{type(client_optimizer).__name__} cannot run in the captured step; pass "
                    "one of the port's FusedAdam, FusedAdamW, FusedLamb, SGD or "
                    "DeepSpeedCPUAdagrad")
            return client_optimizer
        name = self.config.optimizer_name
        if name is None:
            return DummyOptim()
        p = dict(self.config.optimizer_params or {})
        p.pop("torch_adam", None)        # accepted in reference configs; no-op
        if name == "adamw":
            p.pop("adam_w_mode", None)   # implied by the optimizer type
            return FusedAdamW(**p)
        if name == "lamb":
            return FusedLamb(**p)
        if name == "sgd":
            return SGD(**p)
        if name == "adagrad":
            return DeepSpeedCPUAdagrad(**p)
        return FusedAdam(**p)

    def _configure_lr_scheduler(self, client_scheduler=None):
        if client_scheduler is not None:
            missing = [a for a in ("lr_fn", "step") if not callable(
                getattr(client_scheduler, a, None))]
            if missing:
                raise TypeError(f"client lr_scheduler {type(client_scheduler).__name__} has no "
                                f"{' / '.join(missing)}: the captured step takes its lr from "
                                "lr_fn(step) each step (the port's lr_schedules classes)")
            return client_scheduler
        if self.config.scheduler_name is not None:
            return get_lr_scheduler(self.config.scheduler_name,
                                    self.config.scheduler_params,
                                    optimizer=self.optimizer)
        return None

    def _lr_at(self, step):
        """The lr of global step ``step`` (a host float)."""
        if self.lr_scheduler is not None:
            return self.lr_scheduler.lr_fn(step)
        return float(getattr(self.optimizer, "lr", 0.0))

    def _check_param_stream(self, model, client_optimizer, params):
        """JAX's validation of ``offload_param`` (:227-268); returns whether
        the engine streams its parameters."""
        zc = self.config.zero_config
        if zc.offload_param_device() not in ("cpu", "nvme"):
            return False
        offload_wanted = (zc.offload_optimizer_device() in ("cpu", "nvme")
                          and client_optimizer is None
                          and self.config.optimizer_name is not None)
        if self.config.zero_optimization_stage != 3:
            raise ValueError("zero_optimization.offload_param requires stage 3 "
                             f"(got stage {self.config.zero_optimization_stage})")
        if not offload_wanted:
            raise ValueError("offload_param requires offload_optimizer (cpu or nvme) with a "
                             "config-specified Adam/AdamW: streamed parameters have no "
                             "device-resident master for an in-device optimizer to update")
        if self.config.fp16_enabled:
            raise ValueError("offload_param does not support fp16 dynamic loss scaling; use "
                             "bf16 or fp32")
        if not callable(getattr(model, "stream_fns", None)):
            raise ValueError("offload_param needs a model exposing stream_fns() (decomposed "
                             "embed/block/head forward) — GPT2 and compatible families "
                             "provide it")
        if (params is None and zc.offload_param.fast_init
                and not callable(getattr(model, "init_numpy", None))):
            raise ValueError("offload_param.fast_init requires the model to expose "
                             "init_numpy(seed) (a host-RAM init twin)")
        return True

    def _configure_offload(self, client_optimizer, params):
        """The host tier (JAX :333-406): built when the config offloads the
        optimizer to the CPU and names one; over the stream tree, with the
        runner, when the parameters stream (JAX :348-392)."""
        self._offload = None
        self._param_stream = None
        self._dpu = False
        self._dpu_warmup = 0
        self._pending_offload = None      # (wire handle, metrics) of DPU's pending step
        self._pending_row_drop_checks = []   # the sparse wire's device drop counts
        self._sparse_grad_paths = ()
        off = self.config.zero_config.offload_optimizer
        if (off is None or off.device not in ("cpu", "nvme")
                or isinstance(self.optimizer, DummyOptim)):
            self._configure_sparse_wire()
            return
        if client_optimizer is not None:
            raise ValueError(OFFLOAD_CLIENT_ERROR)
        name = self.config.optimizer_name or "adam"
        if name not in ("adam", "adamw"):
            raise ValueError(f"offload_optimizer requires Adam/AdamW (got {name!r}; "
                             "reference parity: DeepSpeedCPUAdam)")
        from .zero import wire
        from .zero.offload_engine import HostOffloadOptimizer
        zc = self.config.zero_config
        if self._streamed:
            from .zero import param_stream as ps
            sf = self.module.stream_fns()
            tree = ps.to_stream_tree(params, sf["stacked_key"])
            del params
            # consume_params drops each init leaf as the master absorbs it; the
            # buffers come after (the init tree, master and buffers never all at once)
            self._offload = HostOffloadOptimizer(
                tree, zc, optimizer_name=name, optimizer_params=self.config.optimizer_params,
                compute_dtype=self.compute_dtype, device=self.device,
                aio_config=self.config.aio_config, retry=self.config.io_retry_config.policy(),
                consume_params=True, payload_in_ram=zc.offload_param_device() == "cpu")
            del tree
            self._offload.alloc_buffers(flat_wire=False)
            cfg = self._health_cfg
            self._param_stream = ps.ParamStreamRunner(
                self.module, self._offload, self.device,
                gas=self.config.gradient_accumulation_steps,
                grad_clip=self.config.gradient_clipping, zero_config=zc,
                aio_config=self.config.aio_config, retry=self.config.io_retry_config.policy(),
                skip_nonfinite=self._health_enabled and cfg.skip_nonfinite,
                spike=((cfg.spike_window, cfg.spike_zmax, cfg.skip_on_spike)
                       if self._health_enabled else None))
            if off.delayed_param_update:
                log_dist("offload_param: delayed_param_update has no effect on the streamed "
                         "step, which runs synchronously (as the JAX engine's does)", ranks=[0])
            self._host_opt_steps = 0
            self.offload_times = {}
            self._configure_sparse_wire()
            return
        self._offload = HostOffloadOptimizer(
            params, zc, optimizer_name=name,
            optimizer_params=self.config.optimizer_params, compute_dtype=self.compute_dtype,
            device=self.device, aio_config=self.config.aio_config,
            retry=self.config.io_retry_config.policy())
        if self._health_enabled and self._health_cfg.skip_nonfinite:
            # JAX :1240-1244: the update runs on the host, so no params sentinel
            log_dist("offload_optimizer: health.skip_nonfinite checks the gradients and "
                     "the loss only; the updated params are not checked (the host updates "
                     "them)", ranks=[0])
        self._dpu = bool(off.delayed_param_update)
        self._dpu_warmup = off.delayed_param_update_warmup if self._dpu else 0
        self._copies = wire.CopyStream(self.device)
        self._h2d = wire.H2DUploader(self._copies)
        self._host_opt_steps = 0            # the host mirror of optimizer_steps
        self._skip_host = wire.pinned(1, torch.bool, self.device)
        self._settled_event = None          # the last copy out of _param_stage
        self._grad_stage = None             # DPU's device copy of the flat gradients
        self._last_d2h = None               # the event of the last d2h's end (flags included)
        self._host_pool = None              # the thread DPU's host work runs on
        self.offload_times = {}             # the last host update's split (seconds)
        self._sparse_host = {}              # pinned landings of the sparse wire, by name
        self._configure_sparse_wire()

    def _configure_sparse_wire(self):
        """The declared row-sparse leaves (JAX :413-432)."""
        if not self.config.sparse_gradients_enabled:
            return
        declared = getattr(self.module, "sparse_grad_paths", None)
        if callable(declared):
            self._sparse_grad_paths = tuple(tuple(p) for p in declared())
        if not self._sparse_grad_paths:
            log_dist("sparse_gradients enabled but the model declares no "
                     "sparse_grad_paths(); gradients stay dense", ranks=[0])
        elif self._offload is None or self._param_stream is not None:
            log_dist("sparse_gradients: the sparse wire format applies to the offload d2h "
                     "path only", ranks=[0])

    # ------------------------------------------------------------------- state
    def _init_state(self, master):
        """fp32 master (16-bit training only), compute-dtype params, optimizer
        state over the fp32 base, device step counters, health EMA, and in
        fp16 the loss scaler (``self.scale`` is its state, updated in place).
        Under offload the params come from the host payload image and the
        device holds no master or optimizer state."""
        if self._param_stream is not None:
            # nothing model-sized on the card: the runner keeps the nonblock
            # params, the host the rest; its sentinels are host values
            self._needs_master = False
            self.master = self.opt_state = self.params = None
        elif self._offload is not None:
            self._needs_master = False
            self.master = None
            self.opt_state = None
            off = self._offload
            flat = off.payload.to(self.device)
            self.params = off._unflatten_like(flat)
            # where every upload lands before it is copied into the params
            self._param_stage = torch.empty_like(flat)
        elif self._needs_master:
            self.master = master
            self.params = tree_cast(master, self.compute_dtype)
        else:
            self.master = None
            self.params = master
        if self._offload is None:
            self.opt_state = self.optimizer.init(self._base)
        z = lambda: torch.zeros((), dtype=torch.int32, device=self.device)
        self._optimizer_steps, self._skipped_steps = z(), z()
        self.health = (hmod.init_state(self.device)
                       if self._health_enabled and self._param_stream is None else None)
        self._scaler = (ls.create_loss_scaler(self.config.fp16, self.device)
                        if self.fp16_enabled else None)
        self.scale = self._scaler.state if self._scaler is not None else None

    @property
    def _base(self):
        """What the optimizer updates: the fp32 master, or the fp32 params."""
        return self.master if self._needs_master else self.params

    # -------------------------------------------------------------- train step
    def _grad_fn(self, base, batch, seed):
        """fp32 gradients of ``mean loss`` (times the loss scale in fp16)
        w.r.t. ``base`` over the ``gas`` microbatches of ``batch`` (leaves
        shaped (gas, micro, ...)), through the cast to the compute dtype.
        Returns ``(grads, scaled_loss)``."""
        gas = self.gradient_accumulation_steps()
        leaves = tree_leaves(base)
        acc_dtype = (torch.bfloat16 if gas > 1 and self.config.grad_accum_dtype == "bf16"
                     else torch.float32)
        acc, loss_sum = None, torch.zeros((), device=self.device)
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            for i in range(gas):
                mb = tree_map(lambda a: a[i], batch)
                p = tree_cast(base, self.compute_dtype) if self._needs_master else base
                loss = self._loss_fn(p, mb, _fold(seed, i))
                if self.scale is not None:
                    loss = loss * self.scale.cur_scale
                scaled = loss / gas
                grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
                loss_sum = loss_sum + scaled.detach().float()
                grads = [torch.zeros(l.shape, dtype=acc_dtype, device=l.device)
                         if g is None else g.to(acc_dtype)
                         for g, l in zip(grads, leaves)]
                acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        by_leaf = {id(leaf): g.float() for leaf, g in zip(leaves, acc)}
        return tree_map(lambda leaf: by_leaf[id(leaf)], base), loss_sum

    def _grads_and_metrics(self, base, batch, seed):
        """Gradients, unscaled and scanned for overflow in fp16 (JAX :1068-1113:
        unscale, overflow, clip), clipped by global norm, and the step's
        metrics (``overflow`` and ``loss_scale`` in fp16)."""
        grads, loss = self._grad_fn(base, batch, seed)
        metrics = {}
        if self.scale is not None:
            cur_scale = self.scale.cur_scale
            grads = tree_map(lambda g: g / cur_scale, grads)
            loss = loss / cur_scale
            metrics = {"overflow": ls.has_overflow(grads), "loss_scale": cur_scale.clone()}
        if self.config.gradient_clipping > 0:
            grads, gnorm = clip_by_global_norm(grads, self.config.gradient_clipping)
        else:
            gnorm = global_norm(grads)
        return grads, {"loss": loss, "grad_norm": gnorm, **metrics}

    def _health_sentinels(self, loss, grads, overflow=None):
        """``(skip, new_health, metrics)``: the device flags gating the step.
        In fp16 the skip starts from ``overflow``, and the gradient flag
        reuses that scan (JAX :1115-1137)."""
        cfg = self._health_cfg
        nf_grads = hmod.tree_nonfinite(grads) if overflow is None else overflow
        nf_loss = ~torch.isfinite(loss)
        new_health, z, spike = hmod.update_ema(self.health, loss,
                                               window=cfg.spike_window, zmax=cfg.spike_zmax)
        skip = self._start_skip(overflow)
        if cfg.skip_nonfinite:
            skip = skip | nf_grads | nf_loss
        if cfg.skip_on_spike:
            skip = skip | spike
        return skip, new_health, {"nonfinite_grads": nf_grads, "nonfinite_loss": nf_loss,
                                  "health_z": z, "loss_spike": spike}

    def _train_step(self, batch, seed, lr, commit):
        """One optimizer step over the gas microbatches of ``batch``,
        committed in place where ``commit`` (a 0-d bool tensor) holds and
        the step is not skipped (a ``where`` no-op otherwise).  ``lr`` is a
        0-d fp32 tensor.  Returns the step's device metrics."""
        base = self._base
        grads, metrics = self._grads_and_metrics(base, batch, seed)
        with torch.no_grad():
            skip = self._advance_guards(grads, metrics, commit)
            new_base, new_opt = self.optimizer.update(
                grads, self.opt_state, base, step=self._optimizer_steps + 1, lr=lr)
            del grads
            if self._health_enabled and self._health_cfg.skip_nonfinite:
                nf_params = hmod.tree_nonfinite(new_base)
                skip = skip | nf_params
                metrics["nonfinite_params"] = nf_params
            keep = skip | ~commit

            def put(old, new):
                torch.where(keep, old, new, out=old)
            tree_map(put, base, new_base)
            tree_map(put, self.opt_state, new_opt)
            if self._needs_master:
                tree_map(lambda p, m: p.copy_(m), self.params, self.master)
            self._optimizer_steps += (commit & ~skip).int()
            self._skipped_steps += (commit & skip).int()
        metrics["skip"] = skip
        return metrics

    def _grad_only_step(self, batch, seed, commit):
        """The device half of the offload step (JAX :1224-1286): gradients
        of the params, unscaled, clipped and flattened into one buffer of
        the wire dtype (bf16 under bf16: its range is fp32's, so no inf
        appears after the overflow scan; fp32 otherwise), the loss scale
        and the health EMA advanced in place under ``commit``, and the
        unified ``skip``.  Returns the metrics with the flat buffer under
        ``"grads"``."""
        grads, metrics = self._grads_and_metrics(self.params, batch, seed)
        with torch.no_grad():
            skip = self._advance_guards(grads, metrics, commit)
            leaves = [g.to(self._offload.wire_dtype) for g in tree_leaves(grads)]
            del grads
            if self._sparse_grad_paths:
                leaves, sparse, metrics["sparse_rows_dropped"] = self._sparsify_grads(
                    leaves, batch)
                for i, (idx, vals) in sparse.items():
                    metrics[f"sparse/{i}/indices"], metrics[f"sparse/{i}/values"] = idx, vals
            metrics["grads"] = torch.cat([g.reshape(-1) for g in leaves])
        metrics["skip"] = skip
        return metrics

    def _sparse_leaf_ids(self):
        """``{leaf position: path}`` of the declared sparse paths in the
        parameter tree (positions in :func:`tree_leaves` order)."""
        def walk(tree, path):
            if isinstance(tree, dict):
                for k in sorted(tree):
                    yield from walk(tree[k], path + (k,))
            elif isinstance(tree, (tuple, list)):
                for i, t in enumerate(tree):
                    yield from walk(t, path + (i,))
            else:
                yield path
        paths = list(walk(self.params, ()))
        missing = [p for p in self._sparse_grad_paths if p not in paths]
        if missing:
            raise ValueError(f"sparse_grad_paths {missing} name no parameter leaf")
        return {paths.index(p): p for p in self._sparse_grad_paths}

    def _sparsify_grads(self, leaves, batch):
        """The declared leaves as row-sparse (indices, values) for the d2h
        wire (JAX :1287-1340).  The static row bound is the model's
        ``sparse_grad_row_bound(batch)``, else the batch's integer id count
        (safe: a lookup touches at most one row an id); a leaf with no more
        rows than that stays dense.  The nonzero rows past the bound are
        counted on the card (``dropped``), never silently lost.  Returns
        ``(dense leaves, {position: (indices, values)}, dropped)``."""
        from .sparse_tensor import SparseTensor
        bound_fn = getattr(self.module, "sparse_grad_row_bound", None)
        if callable(bound_fn):
            tokens = int(bound_fn(batch))
        else:
            tokens = sum(leaf.numel() for leaf in tree_leaves(batch)
                         if not (leaf.is_floating_point() or leaf.is_complex()
                                 or leaf.dtype == torch.bool))
        dropped = torch.zeros((), dtype=torch.int32, device=self.device)
        dense, sparse = [], {}
        ids = self._sparse_leaf_ids() if tokens else {}
        for i, g in enumerate(leaves):
            if i in ids:
                if g.dim() != 2:
                    raise ValueError(f"sparse_grad_paths leaf {ids[i]} must be 2-D (rows, dim)")
                if tokens < g.shape[0]:           # else dense is smaller: keep it
                    nz = (g != 0).any(dim=1)
                    dropped = dropped + torch.clamp(nz.sum(dtype=torch.int32) - tokens, min=0)
                    st = SparseTensor.from_dense(g, max_rows=tokens, nz=nz)
                    sparse[i] = (st.indices, st.values)
                    continue
            dense.append(g)
        return dense, sparse, dropped

    def _advance_guards(self, grads, metrics, commit):
        """The guards both steps share (JAX :1115-1175): the skip flag from
        the fp16 overflow and the health sentinels (their flags added to
        ``metrics``), then the health EMA and the loss scale advanced in
        place under ``commit``.  Returns ``skip``."""
        overflow = metrics.get("overflow")
        if self._health_enabled:
            skip, new_health, sm = self._health_sentinels(metrics["loss"], grads, overflow)
            metrics.update(sm)
            for old, new in zip(self.health, new_health):
                torch.where(commit, new, old, out=old)
        else:
            skip = self._start_skip(overflow)
        if self.scale is not None:
            # the scale reacts to an overflow only, never to a health skip
            new_scale = ls.update_scale(self.scale, overflow, **self._scaler.update_kwargs())
            for old, new in zip(self.scale, new_scale):
                torch.where(commit, new, old, out=old)
        return skip

    def _start_skip(self, overflow):
        """The skip flag before the health sentinels: the fp16 overflow
        (JAX's ``gate``, :1175), else False."""
        if overflow is not None:
            return overflow.clone()
        return torch.zeros((), dtype=torch.bool, device=self.device)

    def _step_for(self, batch, named):
        """The :class:`StepGraph` of this batch's leaf shapes and dtypes,
        built at first use; its body rebuilds ``batch``'s structure from
        the named leaves."""
        gas = self.gradient_accumulation_steps()
        key = (tuple((n, a.shape, a.dtype.str) for n, a in sorted(named.items())), gas)
        step = self._steps.get(key)
        if step is None:
            if self.curriculum_scheduler is not None and self._steps:
                self._release_graphs()     # a new difficulty: the shorter ones never return
            if (self.step_impl == "graph" and self.device.type == "cuda"
                    and self._graphs is None):
                self._graphs = GraphPool(self.device)
            pool = self._graphs if self.step_impl == "graph" else None
            inputs = {n: torch.from_numpy(np.array(a)) for n, a in named.items()}
            inputs["commit"] = torch.tensor(False)   # the warm-up and the capture train not
            inputs["lr"] = torch.zeros((), dtype=torch.float32)
            shapes = ",".join(f"{n[6:]}:{'x'.join(map(str, a.shape))}"
                              for n, a in sorted(named.items()))

            if self._offload is not None:
                def body(seed, commit, lr, **leaves):   # the host half takes the lr
                    return self._grad_only_step(_like(batch, leaves), seed, commit)
            else:
                def body(seed, commit, lr, **leaves):
                    return self._train_step(_like(batch, leaves), seed, lr, commit)
            what = "grad_step" if self._offload is not None else "train"
            step = self._steps[key] = StepGraph(
                f"engine.{what}[{shapes},gas{gas}]", body, inputs, self.device, pool,
                seeded=True, hint=CAPTURE_HINT)
        return step

    def _release_graphs(self):
        """Free the step graphs held (those of the past curriculum
        difficulties) and capture later steps into a new pool: a private
        pool takes no capture once its last graph is freed.  On the card the
        freed pool's segments and the cached blocks go back to the driver
        before the next warm-up and capture, which cannot free them (the
        allocator frees no cached block during a capture)."""
        for old in self._steps.values():
            old.release()
            self._released.append(old)
        self._steps.clear()
        if self._graphs is not None:
            self._graphs = self._graphs.fresh()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- public API
    def train_batch(self, data_iter=None):
        """One training step (gas microbatches → one optimizer step);
        returns the step's mean loss as a 0-dim device tensor (a clone:
        the next step does not overwrite it)."""
        fault.site("engine.step")        # host-side only
        it = data_iter if data_iter is not None else self._data_iterator
        if it is None:
            raise ValueError("train_batch needs training_data or a data_iter")
        if it is not self._data_iterator:
            # an external iterator: the engine's loader no longer tracks the
            # stream, so a rewind must not fast-forward it
            self._stream_pos_known = False
        micro_batches = [next(it) for _ in range(self.gradient_accumulation_steps())]
        # this step's data-stream position: checkpointed with the loader
        # state, and the index the value faults key on
        index = self._last_batch_index = self._stream_step
        self._stream_step += 1
        if fault.is_enabled():
            micro_batches = [fault.corrupt_batch(mb, index) for mb in micro_batches]
        if self.curriculum_scheduler is not None:
            micro_batches = [self._apply_curriculum(mb) for mb in micro_batches]
        return self._run_step(micro_batches)

    def _run_step(self, micro_batches):
        """The captured step over ``micro_batches`` (gas host micro-batches),
        shared by :meth:`train_batch` and :meth:`step`; returns the loss."""
        if self._param_stream is not None:
            return self._run_stream_step(micro_batches)
        batch = self._stack_microbatches(micro_batches)
        named = _named_leaves(batch)
        lr = self._lr_at(self._global_steps)
        step = self._step_for(batch, named)
        host = None
        if self._offload is not None and self._pending_offload is not None:
            # DPU: the pending step's host work runs beside the replay, which holds the
            # calling thread until most of the step's launches have run
            pending, self._pending_offload = self._pending_offload, None
            host = (self._host_worker().submit(self._host_offload_compute, pending[0],
                                               pending[1]["lr"]), pending[1])
        out = step(step_seed=_fold(self._rng_seed, self.micro_steps),
                   commit=np.bool_(True), lr=np.float32(lr), **named)
        metrics = {k: v.clone() for k, v in out.items()
                   if k != "grads" and not k.startswith("sparse/")}
        metrics["lr"] = lr
        if self._offload is not None:
            # the sparse leaves' rows, cloned: the next replay rewrites the outputs
            sparse = {int(k.split("/")[1]): (v.clone(), out[k[:-len("indices")] + "values"].clone())
                      for k, v in out.items() if k.startswith("sparse/") and
                      k.endswith("/indices")}
            self._offload_after_replay(out["grads"], metrics, host, sparse)
        return self._finish_step(metrics)

    def _run_stream_step(self, micro_batches):
        """The ZeRO-3 parameter-offload step (JAX :1532-1563): the runner
        streams the layer blocks through the card and runs the host step;
        the counters follow its skip flag as the fused path's do."""
        lr = self._lr_at(self._global_steps)
        metrics = self._param_stream.train_step(
            micro_batches, _fold(self._rng_seed, self.micro_steps), lr=lr,
            step_no=self._host_opt_steps + 1)
        self.offload_times = self._param_stream.last_times
        if bool(metrics["skip"]):
            self._skipped_steps += 1
        else:
            self._optimizer_steps += 1
            self._host_opt_steps += 1
        return self._finish_step(metrics)

    def _host_worker(self):
        """The one thread the host half of a DPU step runs on."""
        if self._host_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._host_pool = ThreadPoolExecutor(max_workers=1,
                                                 thread_name_prefix="offload-host")
        return self._host_pool

    # ------------------------------------------- the offload step's host half
    def _offload_after_replay(self, flat, metrics, host=None, sparse=None):
        """After the device half's replay (JAX :1493-1526): start the d2h of
        its flat gradients and ``skip``, then apply a step on the host: this
        one (synchronous), or under DPU past the warm-up the pending one
        (``host``: its host work, submitted before the replay, and its
        metrics), leaving this one pending."""
        from .zero import wire
        from .zero.offload_engine import FlatWireHandle
        dpu = self._dpu and self._global_steps >= self._dpu_warmup
        if dpu:
            # the next replay rewrites `flat` while this d2h may still run: copy it
            # on the device first, after the last d2h from the stage
            if self._grad_stage is None:
                self._grad_stage = torch.empty_like(flat)
            if self._last_d2h is not None:
                torch.cuda.current_stream(self.device).wait_event(self._last_d2h)
            self._grad_stage.copy_(flat)
            flat = self._grad_stage
        if host is not None:
            future, pending_metrics = host
            self._host_offload_finish(future.result(), pending_metrics)
        extra = [(metrics["skip"].reshape(1), self._skip_host)]
        landing, host_sparse = self._offload.landing, None
        if sparse:
            # the other leaves land in a buffer of their own (the fp32 wire's landing
            # is grad32, which flatten_grads writes); the rows in pinned buffers
            landing = self._sparse_landing("dense", flat)
            host_sparse = {i: (self._sparse_landing((i, 0), a), self._sparse_landing((i, 1), b))
                           for i, (a, b) in sparse.items()}
            extra += [(a, host_sparse[i][0]) for i, (a, _) in sparse.items()]
            extra += [(b, host_sparse[i][1]) for i, (_, b) in sparse.items()]
        handle = FlatWireHandle(wire.d2h_flat_start(
            flat, landing, self._copies, after=self._copies.event(), extra=tuple(extra)),
            dense=landing if sparse else None, sparse=host_sparse)
        self._last_d2h = None if handle.handle is None else handle.handle[2]
        if dpu:
            self._pending_offload = (handle, metrics)
        else:
            self._host_offload_update(handle, metrics)

    def _sparse_landing(self, name, like):
        """The pinned host buffer ``name`` of the sparse wire, shaped as the
        device tensor ``like`` (made at first use, then reused: a step's
        host work ends before the next step's d2h starts)."""
        from .zero import wire
        buf = self._sparse_host.get(name)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = self._sparse_host[name] = wire.pinned(like.numel(), like.dtype,
                                                        self.device).view(like.shape)
        return buf

    def _host_offload_update(self, handle, metrics):
        """The host half (JAX :1337-1420) in the calling thread."""
        self._host_offload_finish(self._host_offload_compute(handle, metrics["lr"]), metrics)

    def _host_offload_compute(self, handle, lr):
        """The host half's host work, which touches no device stream (a DPU
        step runs it on a worker thread): land the d2h of the gradients and
        the skip flag, then, unless the step is skipped, widen them and run
        the native Adam, whose copy-back writes the payload image.  Returns
        ``(skip, times)``."""
        from .zero import wire
        t0 = time.perf_counter()
        wire.d2h_flat_land(handle.handle)
        t1 = time.perf_counter()
        times = {"land_wait_s": t1 - t0, "d2h_s": wire.seconds(handle.handle)}
        skip = bool(self._skip_host[0])
        if not skip:
            if handle.sparse is not None:
                flat = self._offload.flatten_grads(
                    self._offload.wire_tree(handle.dense, handle.sparse))
            else:
                flat = self._offload.widen()
            t2 = time.perf_counter()
            self._offload.step(flat, self._host_opt_steps + 1, lr)
            times.update(widen_s=t2 - t1, host_step_s=time.perf_counter() - t2)
        return skip, times

    def _host_offload_finish(self, result, metrics):
        """The host half's stream work, on the calling thread: the upload
        of the payload into the stage and its copy into the params, and the
        step counters."""
        skip, times = result
        if not skip and "sparse_rows_dropped" in metrics:
            # checked on applied steps only (a NaN step makes every row nonzero), read
            # on reporting steps, every 50 and at every flush: a read syncs the stream
            self._pending_row_drop_checks.append(metrics["sparse_rows_dropped"])
            if ((self._global_steps + 1) % self.config.steps_per_print == 0
                    or len(self._pending_row_drop_checks) >= 50):
                self._flush_row_drop_checks()
        if skip:
            self._skipped_steps += 1
        else:
            self._host_opt_steps += 1
            # the stage's last reader is the copy into the params below
            landed = self._h2d.upload(self._offload.payload, self._param_stage,
                                      after=self._settled_event)
            # the copy into the params goes behind the replays already on the compute
            # stream, which read the old params; the next replay reads the new ones
            if landed is not None:
                torch.cuda.current_stream(self.device).wait_event(landed)
            with torch.no_grad():
                self._offload.copy_into(self.params, self._param_stage)
            self._settled_event = self._copies.event()
            self._optimizer_steps += 1
            times["upload"] = self._h2d.last
        self.offload_times = times

    def _flush_row_drop_checks(self):
        """Read the pending drop counts (a sync) and raise if a sparse
        gradient row was dropped since the last read (JAX :1913-1925)."""
        pending, self._pending_row_drop_checks = self._pending_row_drop_checks, []
        n_dropped = sum(int(x) for x in pending)
        if n_dropped > 0:
            raise RuntimeError(
                f"sparse_grad_row_bound under-declared: {n_dropped} nonzero gradient row(s) "
                "exceeded the declared bound within the last reporting interval and were "
                "dropped; raise the bound (or remove sparse_grad_row_bound to use the safe "
                "default)")

    def _flush_offload(self):
        """Apply a pending DPU step, so exported or evaluated state reflects
        every batch seen (JAX :1927-1941); the sparse wire's drop counts are
        read before and after it, so no export skips the check."""
        self._flush_row_drop_checks()
        if self._offload is not None and self._pending_offload is not None:
            pending, self._pending_offload = self._pending_offload, None
            self._host_offload_update(*pending)
            self._flush_row_drop_checks()

    def offload_state(self):
        """The host tier after a flush: ``{"master", "exp_avg",
        "exp_avg_sq"}``, flat fp32 numpy arrays (views, not copies)."""
        self._flush_offload()
        m, v = self._offload.moments()
        return {"master": self._offload.master, "exp_avg": m, "exp_avg_sq": v}

    def _apply_curriculum(self, mb):
        """Crop a host micro-batch to the difficulty of the coming step
        (JAX :1445-1457): along axis 1, integer leaves to ``seqlen + 1``
        (next-token targets), the rest to ``seqlen``."""
        seqlen = self.curriculum_scheduler.update_difficulty(self._global_steps + 1)

        def crop(x):
            x = np.asarray(x)
            if x.ndim >= 2 and x.shape[1] > seqlen:
                return x[:, :seqlen + 1] if np.issubdtype(x.dtype, np.integer) else \
                    x[:, :seqlen]
            return x
        return tree_map(crop, mb)

    def curriculum_seqlen(self):
        """The current curriculum difficulty, or None without a curriculum."""
        if self.curriculum_scheduler is None:
            return None
        return self.curriculum_scheduler.get_current_difficulty()

    # ------------------------------------------------ the imperative API (JAX :1964-1998)
    def forward(self, batch, rng=None):
        """Stage ``batch`` (one host micro-batch) for :meth:`backward` and
        return its loss without gradients (:meth:`eval_batch`)."""
        self._staged_batch = batch
        return self.eval_batch(batch, rng)

    def backward(self, loss=None):
        """Queue the staged micro-batch; its gradients are taken inside the
        step :meth:`step` runs at the accumulation boundary.  Returns
        ``loss``."""
        if self._staged_batch is None:
            raise RuntimeError("call forward(batch) before backward()")
        self._pending_microbatches.append(self._staged_batch)
        self._staged_batch = None
        return loss

    def is_gradient_accumulation_boundary(self):
        """Whether ``gas`` micro-batches are queued (the reference's
        ``engine.py:1267``)."""
        return len(self._pending_microbatches) >= self.gradient_accumulation_steps()

    def step(self):
        """At the accumulation boundary, the step :meth:`train_batch` runs
        (the same graph) over the queued micro-batches; returns its loss,
        or None before the boundary."""
        if not self.is_gradient_accumulation_boundary():
            return None
        micro_batches, self._pending_microbatches = self._pending_microbatches, []
        return self._run_step(micro_batches)

    def _stack_microbatches(self, micro_batches):
        """Host microbatches → one host tree of numpy arrays with a leading
        gas axis (the step's static inputs take them)."""
        return tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *micro_batches)

    def _finish_step(self, metrics):
        self._last_metrics = metrics
        self.micro_steps += self.gradient_accumulation_steps()
        self.global_samples += self.train_batch_size()
        self._global_steps += 1
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.progressive_layer_drop is not None:
            self.progressive_layer_drop.update_state(self._global_steps)
        if self._global_steps % self.config.steps_per_print == 0:
            # the only host read of a step, on reporting steps
            msg = (f"step={self._global_steps}, loss={float(metrics['loss']):.6f}, "
                   f"lr={metrics['lr']:.3e}")
            if self.fp16_enabled:
                msg += (f", loss_scale={float(metrics['loss_scale']):.1f}"
                        f", skipped={self.skipped_steps}")
            elif self._health_enabled and bool(metrics["skip"]):
                msg += f", SKIPPED (health sentinel; total {self.skipped_steps})"
            log_dist(msg, ranks=[0])
        if self.health_monitor is not None:
            # trails the card by check_interval steps; may rewind or abort
            self._health_observe(self._global_steps, self._landed_sentinels(metrics))
        return metrics["loss"]

    def _landed_sentinels(self, metrics):
        """The step's sentinels for the monitor: on the card one pinned copy
        (of a ring of ``check_interval + 2``) queued right behind the step
        and an event after it, so the monitor's late read waits on this step
        only; on the CPU the tensors themselves."""
        keys = [k for k in hmod.METRIC_KEYS if isinstance(metrics.get(k), torch.Tensor)]
        if self.device.type != "cuda" or self._param_stream is not None:
            return {k: metrics[k] for k in keys}      # host values (the streamed step's too)
        ring = self._sentinel_ring
        if ring is None or ring[0].numel() != len(keys):
            ring = self._sentinel_ring = [
                torch.empty(len(keys), pin_memory=True)
                for _ in range(int(self._health_cfg.check_interval) + 2)]
        buf = ring[self._sentinel_slot % len(ring)]
        self._sentinel_slot += 1
        buf.copy_(torch.stack([metrics[k].reshape(()).float() for k in keys]), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return {k: hmod.LandedScalar(buf, i, event) for i, k in enumerate(keys)}

    # ------------------------------------------------ the health ladder (JAX :1733-1856)
    def _health_observe(self, step_no, metrics):
        """Feed the step's sentinels to the monitor and carry out the
        action it escalates to."""
        action = self.health_monitor.observe(step_no, self._last_batch_index, metrics)
        if action == "rewind":
            self._health_rewind()
        elif action == "abort":
            self._health_abort("consecutive-skip budget exhausted and rewind limit spent")

    def _health_abort(self, reason):
        # the lag window first: the steps that tripped the abort belong in the history
        self.health_monitor.flush()
        path = self.health_monitor.forensic_dump(self._forensic_dir(), reason,
                                                 last_good_tag=self.loaded_checkpoint_tag)
        raise hmod.TrainingHealthError(
            f"training health: {reason}; counters={self.health_monitor.counters()}"
            + (f"; forensics at {path}" if path else ""), forensic_path=path)

    def _forensic_dir(self):
        return (self._health_cfg.forensic_dir or self.config.checkpoint_config.dir
                or self._last_ckpt_dir or os.getcwd())

    def _health_rewind(self):
        """Rewind to the newest valid checkpoint and fast-forward past the
        last poisoned batch.  A rewind that runs straight back into skips
        (no clean step since the last one: the same poison window) doubles
        the stride, so a window of W batches is crossed in O(log W)
        rewinds.  A rewind that cannot run ends in ``on_exhausted``."""
        mon = self.health_monitor
        same_episode = mon.episode_rewinds > 0 and mon.clean_since_rewind == 0
        self._ff_stride = self._ff_stride * 2 if same_episode else 1
        target = mon.last_bad_stream_step
        if target is not None:
            target += self._ff_stride - 1
        try:
            self.rewind(replay_past=target)
        except Exception as e:
            if self._health_cfg.on_exhausted == "warn":
                logger.warning(f"health: rewind unavailable ({e}); on_exhausted=warn, "
                               "continuing without it")
                mon.consecutive_skips = 0
                return
            self._health_abort(f"rewind failed: {e}")
        mon.record_rewind(tag=self.loaded_checkpoint_tag)

    def rewind(self, load_dir=None, tag=None, replay_past=None):
        """Rewind in process: load the newest valid checkpoint (in place),
        then fast-forward the restored data stream past the stream index
        ``replay_past``, so the replay resumes on the batches after it.
        The ladder calls it; an operator may too.  Returns the path."""
        load_dir = load_dir or self._rewind_dir()
        if load_dir is None:
            raise ValueError("rewind needs a checkpoint directory: set checkpoint.dir in "
                             "the config or save/load a checkpoint first")
        path, _ = self.load_checkpoint(load_dir, tag=tag)
        if replay_past is None:
            return path
        if self._data_iterator is None:
            logger.warning("rewind: no engine-owned data iterator to fast-forward (external "
                           "data_iter?); replay will re-feed the stream from the "
                           "checkpointed position")
        elif not self._stream_pos_known:
            logger.warning("rewind: data-stream position unknown (the checkpoint carried no "
                           "data-pipeline state); fast-forward skipped, and replay may "
                           "re-feed already-seen batches")
        else:
            gas = self.gradient_accumulation_steps()
            skipped = max(replay_past - self._stream_step + 1, 0)
            loader = self.training_dataloader
            if (skipped and isinstance(self._data_iterator, RepeatingLoader)
                    and self._data_iterator.loader is loader
                    and hasattr(loader, "load_state_dict")):
                # an O(1) jump of the loader's (epoch, batch_index), where
                # draining would collate every discarded batch
                per_epoch = max(len(loader), 1)
                sd = loader.state_dict()
                pos = sd["epoch"] * per_epoch + sd["batch_index"] + skipped * gas
                loader.load_state_dict({"seed": sd["seed"], "epoch": pos // per_epoch,
                                        "batch_index": pos % per_epoch})
                self._data_iterator = iter(RepeatingLoader(loader))
                self._stream_step += skipped
            else:
                while self._stream_step <= replay_past:
                    for _ in range(gas):
                        next(self._data_iterator)
                    self._stream_step += 1
            log_dist("rewind fast-forward: " + json.dumps(
                {"event": "health_fast_forward", "batches": skipped,
                 "resume_stream_step": self._stream_step}), ranks=[0])
        return path

    def _rewind_dir(self):
        return self.config.checkpoint_config.dir or self._last_ckpt_dir

    def stats(self):
        """The step graphs' counters: ``step_impl``, graphs captured (and
        held), graphs released (past curriculum difficulties), captures,
        warm-ups and replays, dropout draws re-seeded per replay, and each
        graph's pool bytes by its name (the reserved device memory its
        capture added; 0 without a capture), released ones included."""
        steps = self._released + list(self._steps.values())
        return {"graphs": {
            "step_impl": self.step_impl,
            "graphs": sum(s.captured for s in steps),
            "released": len(self._released),
            "captures": sum(s.captures for s in steps),
            "warmups": sum(s.warmups for s in steps),
            "replays": sum(s.replays for s in steps),
            "dropout_draws": sum(s.dropout_draws for s in steps),
            "pool_bytes": {s.name: s.pool_bytes for s in steps}},
            **({"health": self.health_monitor.counters()}
               if self.health_monitor is not None else {})}

    def eval_batch(self, batch, rng=None):
        """The loss of ``batch`` (host arrays) without gradients or update."""
        self._flush_offload()
        if self._param_stream is not None:
            return self._param_stream.eval_loss(batch, 0 if rng is None else int(rng))
        batch = tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(self.device), batch)
        with torch.no_grad():
            return self._loss_fn(self.params, batch, 0 if rng is None else int(rng))

    def deepspeed_io(self, dataset, collate_fn=None):
        """The config-driven loader (micro-batches of
        ``train_micro_batch_size_per_gpu`` samples; ``collate_fn`` batches
        the samples of a dataset that is not columnar, JAX :2003-2015)."""
        return DeepSpeedDataLoader(dataset, batch_size=self.train_micro_batch_size_per_gpu(),
                                   drop_last=self.config.dataloader_drop_last,
                                   collate_fn=collate_fn)

    # ------------------------------------------------------------- accessors
    @property
    def global_steps(self):
        return self._global_steps

    @property
    def skipped_steps(self):
        return int(self._skipped_steps)

    @property
    def optimizer_steps(self):
        return int(self._optimizer_steps)

    def loss_scale(self):
        """The current loss scale (1.0 outside fp16; a host read)."""
        return 1.0 if self._scaler is None else self._scaler.loss_scale

    def train_batch_size(self):
        return self.config.train_batch_size

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def zero_optimization_stage(self):
        return self.zero_stage

    def get_lr(self):
        return [self._lr_at(self._global_steps)]

    def get_global_grad_norm(self):
        m = self._last_metrics.get("grad_norm")
        return float(m) if m is not None else None

    def module_state_dict(self):
        """The full parameters on the host (CPU tensors of the compute
        dtype), after a flush (JAX :2143-2148)."""
        self._flush_offload()
        if self._param_stream is not None:
            return self._param_stream.full_params_host()
        return tree_map(lambda t: t.detach().to("cpu", copy=True), self.params)

    def _params_out(self):
        """The parameters a checkpoint or a 16-bit save writes."""
        if self._param_stream is not None:
            return self._param_stream.full_params_host()
        return self.params

    # ----------------------------------------------------------- checkpoints
    def _get_ckpt_name(self, checkpoints_path, tag):
        return os.path.join(checkpoints_path, str(tag))

    def _engine_meta(self, client_state):
        """The model file's meta record: JAX's keys (engine.py:2189-2222)."""
        loader = self.training_dataloader
        return {
            "global_steps": self.global_steps,
            "optimizer_steps": self.optimizer_steps,
            "skipped_steps": self.skipped_steps,
            "micro_steps": self.micro_steps,
            "global_samples": self.global_samples,
            "zero_stage": self.zero_stage,
            "dtype": self.config.precision_dtype,
            "mesh": dict(ONE_DEVICE_MESH),
            "dp_world_size": 1,
            "train_batch_size": self.train_batch_size(),
            "elasticity": None,
            "client_state": client_state or {},
            "lr_scheduler": (self.lr_scheduler.state_dict()
                             if self.lr_scheduler is not None else None),
            "data_state": {"stream_step": self._stream_step,
                           "loader": loader.state_dict() if loader is not None else None},
        }

    def save_checkpoint(self, save_dir, tag=None, client_state=None, save_latest=True):
        """``<save_dir>/<tag>/{model,optim}_states.msgpack`` + ``<save_dir>/latest``
        (JAX engine.py:2154).  Every file is staged in ``<tag>.tmp``, a
        SHA-256 manifest is written, the tag is published by one rename,
        and ``latest`` and ``keep_n`` rotation follow: a kill at any
        instant leaves the previous checkpoints intact or the new tag whole.
        A failed write raises after the ``io_retry`` policy.  The health
        monitor's lag window is processed first; its verdict is dropped
        (the counters still stand and escalate at the next step)."""
        self._flush_offload()
        if self.health_monitor is not None:
            self.health_monitor.flush()
        tag = tag or f"global_step{self.global_steps}"
        retry = self.config.io_retry_config.policy()
        fsync = self.config.checkpoint_config.fsync
        os.makedirs(save_dir, exist_ok=True)
        # drop staging leftovers of killed saves and restore an orphaned
        # `.replaced` before staging anew
        atomic.clean_stale_staging(save_dir)
        path = atomic.stage_path(save_dir, tag)
        os.makedirs(path)
        # fsync deferred to commit_staged: one durability pass per file
        save_tree(os.path.join(path, MODEL_FILE), {"params": self._params_out()},
                  meta=self._engine_meta(client_state), fsync=False, retry=retry)
        fault.site("ckpt.after_model_file")
        if self._offload is not None:
            # the host tier in the in-device layout (JAX :2231-2245); a streamed
            # engine's layer-major trees go back to the stacked model tree
            moments, master = self._offload.moments_tree(), self._offload.master_tree()
            if self._param_stream is not None:
                from .zero.param_stream import from_stream_tree
                key = self._param_stream.sf["stacked_key"]
                moments = {k: from_stream_tree(v, key) for k, v in moments.items()}
                master = from_stream_tree(master, key)
            optim_tree = {"opt_state": moments, "master": master}
        else:
            optim_tree = {"opt_state": self.opt_state}
        if self.master is not None:
            optim_tree["master"] = self.master
        if self.scale is not None:
            optim_tree["scale"] = self.scale
        save_tree(os.path.join(path, OPTIM_FILE), optim_tree, fsync=False, retry=retry)
        fault.site("ckpt.after_optim_file")
        self._copy_recovery_script(path)
        atomic.write_manifest(path, meta={"tag": tag, "global_steps": self.global_steps,
                                          "format_version": 1})
        fault.site("ckpt.before_commit")
        final = atomic.commit_staged(save_dir, tag, fsync=fsync)
        fault.site("ckpt.after_commit")
        if save_latest:
            atomic.write_latest(save_dir, tag)
        keep_n = self.config.checkpoint_config.keep_n
        if keep_n:
            atomic.rotate_checkpoints(save_dir, keep_n)
        self._last_ckpt_dir = save_dir     # the rewind's directory of last resort
        log_dist(f"saved checkpoint {final}", ranks=[0])
        return True

    def _copy_recovery_script(self, save_path):
        """Drop ``zero_to_fp32.py`` beside the checkpoint (JAX :2285)."""
        from ..utils import zero_to_fp32 as z2f
        dst = os.path.join(save_path, "zero_to_fp32.py")
        try:
            shutil.copy2(z2f.__file__, dst)
            os.chmod(dst, 0o755)
        except OSError as e:
            logger.warning(f"could not copy recovery script: {e}")

    def save_16bit_model(self, save_dir, save_filename="model_16bit.msgpack", fsync=True,
                         retry=None):
        """The params in the compute dtype, with meta ``{"dtype": ...}``
        (JAX :2300)."""
        self._flush_offload()
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        save_tree(path, {"params": self._params_out()},
                  meta={"dtype": self.config.precision_dtype}, fsync=fsync, retry=retry)
        log_dist(f"saved 16-bit model to {path}", ranks=[0])
        return True

    def _resolve_checkpoint_tag(self, load_dir, tag):
        """Validating tag resolution (JAX :2326): an explicit ``tag`` must
        verify (else ``CheckpointValidationError``); the ``latest`` pointer
        falls back to the newest valid tag with one structured warning; a
        manifest-less (legacy) tag loads with a warning; nothing loadable
        raises ``FileNotFoundError``."""
        atomic.clean_stale_staging(load_dir, min_age_s=atomic.LOAD_STAGING_MIN_AGE_S)
        verify = self.config.checkpoint_config.verify
        explicit = tag is not None
        problems = []
        if tag is None:
            tag = atomic.read_latest(load_dir)
            if tag is None:
                problems.append(f"no `latest` pointer in {load_dir}")
        if tag is not None:
            path = self._get_ckpt_name(load_dir, tag)
            if atomic.is_legacy_checkpoint(path):
                logger.warning(f"checkpoint {path} has no manifest (pre-fault-tolerance "
                               f"layout); loading without integrity verification")
                return tag
            ok, tag_problems = atomic.verify_checkpoint(path, level=verify)
            if ok:
                return tag
            if explicit:
                raise atomic.CheckpointValidationError(
                    f"checkpoint {path} failed validation: {tag_problems}")
            problems.extend(tag_problems)
        fallback = atomic.find_latest_valid(load_dir, exclude=(tag,) if tag else (),
                                            level=verify)
        legacy = False
        if fallback is None:
            tags = [t for t in atomic.find_legacy_tags(load_dir) if t != tag]
            if not tags:
                raise FileNotFoundError(f"no loadable checkpoint in {load_dir}: {problems}")
            fallback, legacy = tags[0], True
        event = {"event": "checkpoint_fallback", "load_dir": load_dir, "unusable_tag": tag,
                 "problems": problems, "fallback_tag": fallback}
        if legacy:
            event["legacy"] = True
        logger.warning("checkpoint fallback engaged: " + json.dumps(event))
        return fallback

    def _check_mesh_transition(self, meta):
        """The resume-on-resize gate (JAX :2388) against the one-device
        record: the same mesh loads silently; no record warns; another mesh
        logs JAX's ``elastic_resume`` event, and warns when the global batch
        changed."""
        saved_mesh = meta.get("mesh")
        if saved_mesh is None:
            logger.warning("pre-elastic checkpoint: no mesh/batch record in the checkpoint "
                           f"meta; loading onto mesh {ONE_DEVICE_MESH}, but global-batch "
                           "preservation cannot be verified")
            return
        saved_mesh = {k: int(v) for k, v in saved_mesh.items()}
        if saved_mesh == ONE_DEVICE_MESH:
            return
        saved_tb, cur_tb = meta.get("train_batch_size"), self.train_batch_size()
        event = {"event": "elastic_resume", "from_mesh": saved_mesh,
                 "to_mesh": ONE_DEVICE_MESH, "from_dp_world": meta.get("dp_world_size"),
                 "to_dp_world": 1,
                 "global_batch": {"from": saved_tb, "to": cur_tb,
                                  "preserved": saved_tb == cur_tb},
                 "elastic": False}
        if saved_tb is not None and saved_tb != cur_tb:
            logger.warning("resuming on a different mesh WITHOUT elasticity: the global "
                           f"batch changes {saved_tb} -> {cur_tb}, which changes training "
                           "semantics (lr schedule, convergence).")
        log_dist("elastic resume: " + json.dumps(event), ranks=[0])

    @staticmethod
    def _copy_into(dst_tree, src_tree, what):
        """``dst.copy_(src)`` leaf by leaf (cast to the engine's dtype, moved
        to its device); a leaf of another shape raises."""
        def put(dst, src):
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint {what} leaf of shape {tuple(src.shape)} "
                                 f"!= the engine's {tuple(dst.shape)}")
            dst.copy_(src)
        with torch.no_grad():
            tree_map(put, dst_tree, src_tree)

    def _load_device(self, loaded_params, optim_tree):
        """The in-device state from a checkpoint, copied in place."""
        self._copy_into(self.params, loaded_params, "params")
        if self.master is not None:
            # the master follows the loaded params now; the optimizer file's
            # master, when loaded, overwrites it below
            self._copy_into(self.master, loaded_params, "master")
        if optim_tree is not None:
            self._copy_into(self.opt_state,
                            restore_like(self.opt_state, optim_tree["opt_state"]), "opt_state")
            if "master" in optim_tree and self.master is not None:
                self._copy_into(self.master, restore_like(self.master, optim_tree["master"]),
                                "master")
            self._load_scale(optim_tree)

    def _load_scale(self, optim_tree):
        if "scale" in optim_tree and self.scale is not None:
            # an engine without a scaler ignores the tree, as JAX does
            self._copy_into(self.scale, restore_like(self.scale, optim_tree["scale"]), "scale")
        # comm_error (qgZ error feedback) is ignored: this engine keeps none

    def _load_offload(self, loaded_params, optim_tree):
        """The host tier from a checkpoint (JAX :2505-2534): the master from
        the params (then from the optimizer file's master where it has
        one), the moments from its ``opt_state``, and the params uploaded
        from the refreshed payload image."""
        off = self._offload
        self._h2d.wait()                  # no upload still reads the image
        off.load_state(master_tree=loaded_params)
        if optim_tree is not None:
            opt = optim_tree["opt_state"]
            master = optim_tree.get("master")
            off.load_state(master_tree=None if master is None else restore_like(
                self.params, master), m=restore_like(self.params, opt["exp_avg"]),
                v=restore_like(self.params, opt["exp_avg_sq"]))
            self._load_scale(optim_tree)
        flat = off.payload.to(self.device)
        with torch.no_grad():
            off.copy_into(self.params, flat)

    def _load_stream(self, model_tree, optim_tree):
        """The streamed engine's host tier from a checkpoint (JAX
        :2505-2531): the stacked trees converted to the layer-major layout,
        the master from the params (then from the optimizer file's master
        where it has one), the moments, then the NVMe layer files and the
        card's nonblock params."""
        from .zero.param_stream import to_stream_tree
        key = self._param_stream.sf["stacked_key"]
        tmpl = self._offload._template
        stacked = tree_map(lambda _: 0, {**tmpl["nonblock"], key: tmpl["layers"][0]})
        conv = lambda t: None if t is None else to_stream_tree(  # noqa: E731
            restore_like(stacked, t), key)
        off = self._offload
        off.load_state(master_tree=conv(model_tree["params"]))
        if optim_tree is not None:
            opt = optim_tree["opt_state"]
            off.load_state(master_tree=conv(optim_tree.get("master")),
                           m=conv(opt["exp_avg"]), v=conv(opt["exp_avg_sq"]))
        self._param_stream.reload_from_host()

    def load_checkpoint(self, load_dir, tag=None, load_module_only=False,
                        load_optimizer_states=True, load_lr_scheduler_states=True):
        """Load a manifest-verified checkpoint into the engine's tensors in
        place (JAX :2465).  Returns ``(path, client_state)``."""
        # a pending delayed update is superseded by the loaded state (JAX :2472-2474)
        self._pending_offload = None
        tag = self._resolve_checkpoint_tag(load_dir, tag)
        path = self._get_ckpt_name(load_dir, tag)
        retry = self.config.io_retry_config.policy()
        model_tree, meta = load_tree(os.path.join(path, MODEL_FILE), with_meta=True,
                                     retry=retry)
        self._check_mesh_transition(meta)
        optim_tree = None
        if load_optimizer_states and not load_module_only:
            optim_tree = load_tree(os.path.join(path, OPTIM_FILE), retry=retry)
            extra = sorted(set(optim_tree) - set(OPTIM_TREES))
            if extra:
                raise NotImplementedError(f"checkpoint optimizer keys {extra} are not ported")
        self.loaded_checkpoint_tag = tag
        if self._param_stream is not None:
            self._load_stream(model_tree, optim_tree)
        elif self._offload is not None:
            self._load_offload(restore_like(self.params, model_tree["params"]), optim_tree)
        else:
            self._load_device(restore_like(self.params, model_tree["params"]), optim_tree)
        self._global_steps = int(meta["global_steps"])
        self._optimizer_steps.fill_(int(meta["optimizer_steps"]))
        self._skipped_steps.fill_(int(meta["skipped_steps"]))
        if self._offload is not None:
            self._host_opt_steps = int(meta["optimizer_steps"])
        if self.health is not None:
            # a fresh EMA: the loaded run must not inherit the loss statistics
            # of the steps just discarded (init_state's zeros, in place)
            for t in self.health:
                t.zero_()
        self.micro_steps = meta.get("micro_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        data_state = meta.get("data_state") or {}
        self._stream_step = int(data_state.get("stream_step", 0))
        self._last_batch_index = None
        if data_state.get("loader") is not None and self.training_dataloader is not None:
            exact = self.training_dataloader.load_state_dict(data_state["loader"])
            self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
            self._stream_pos_known = exact is not False
        else:
            # no loader state: the live iterator no longer matches _stream_step
            self._stream_pos_known = False
        if self.health_monitor is not None:
            self.health_monitor.on_checkpoint_load()
        if self._param_stream is not None:
            self._param_stream.reset_health_ema()
        self._last_ckpt_dir = load_dir
        if (load_lr_scheduler_states and self.lr_scheduler is not None
                and meta.get("lr_scheduler") is not None):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        log_dist(f"loaded checkpoint {path} at global_step={meta['global_steps']}", ranks=[0])
        return path, meta.get("client_state", {})
