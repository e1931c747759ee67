"""DeepSpeedEngine: the training loop wrapper, single-device fused path.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``).
Ported: ``_resolve_model``'s parameter source (``params=``, else the
model's own initialiser), ``_configure_optimizer`` (Adam/AdamW),
``_configure_lr_scheduler``,
``_init_state`` (compute-dtype params, fp32 master, fp32 Adam moments,
step counters), ``_grad_fn`` (gradient accumulation in fp32 — or bf16 with
``data_types.grad_accum_dtype`` — of ``loss / gas``),
``_grads_and_metrics`` (clip by global norm), ``_health_sentinels``,
``_train_step`` with the branchless skip-step, ``train_batch``,
``_stack_microbatches``, ``_finish_step``, ``eval_batch``, the
accessors, and checkpoints (JAX :2154-2628): ``save_checkpoint``,
``save_16bit_model``, ``_copy_recovery_script``,
``_resolve_checkpoint_tag``, ``_check_mesh_transition`` and
``load_checkpoint``, in the JAX package's container and layout
(``checkpoint/``), so either package loads the other's checkpoints.
``train_batch`` visits ``fault.site("engine.step")``, counts the
monotonic data-stream index ``_stream_step`` and passes the host
micro-batches through ``fault.corrupt_batch`` (JAX :1409-1430).

As in the JAX engine, gradients are taken with respect to the fp32
master through its cast to the compute dtype (``_micro_loss_fn``), and a
step whose loss, gradients or updated parameters are non-finite (or
whose loss spikes, with ``skip_on_spike``) is a ``torch.where`` no-op on
the master, the parameters and the optimizer state: the skip flag stays
on the device, so the step needs no host sync, and ``optimizer_steps``
(Adam's bias-correction step) does not advance on a skip.

Deliberate differences: eager PyTorch instead of one jitted step; the
state is updated in place (JAX donates it); the engine runs on the
model's device (ZeRO stages 0-2 share the single-device placement);
the lr of a step is a host float (the schedules are pure functions of
the host step counter); dropout seeds are integers folded from
``(rng_seed, micro_steps, microbatch)`` with splitmix64, not PRNG keys.
``load_checkpoint`` copies every leaf into the engine's existing
tensors (``copy_``), so their addresses stay the same; the device step
counters are filled in place and the health EMA zeroed in place (JAX
re-initialises it, :2583-2588).  A checkpoint holds one device's full
arrays, and its meta records JAX's 1-device mesh (:data:`ONE_DEVICE_MESH`);
a checkpoint from a larger mesh loads with JAX's warning when the global
batch changed (``elasticity``, under which JAX raises there, is refused by
the port's config).  What the port does not run raises
``NotImplementedError`` naming the key: a loss ``scale`` (fp16) or any
other optimizer tree but ``opt_state`` / ``master`` / ``comm_error``
(ignored, as JAX ignores it in an engine without error feedback).

Not ported: fp16 loss scaling, offload, ZeRO across ranks, the health
monitor's host ladder (and so rewind), the forward/backward/step shim,
monitoring, curriculum and PLD (the config raises for each), and client
optimizer / scheduler objects.
"""

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
from .dataloader import DeepSpeedDataLoader, RepeatingLoader
from .lr_schedules import get_lr_scheduler
from .utils import (DummyOptim, clip_by_global_norm, global_norm, tree_cast,
                    tree_leaves, tree_map)
from ..inference.engine import sample_seed as _fold
from ..ops.adam.fused_adam import FusedAdam, FusedAdamW
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger

# the mesh record of a checkpoint saved on one device, as the JAX engine
# writes it for its 1-device mesh (the axes of parallel/mesh.py)
ONE_DEVICE_MESH = {"pipe": 1, "data": 1, "fsdp": 1, "expert": 1, "seq": 1, "tensor": 1}
# optimizer-file trees the port loads (comm_error is ignored, see load_checkpoint)
OPTIM_TREES = ("opt_state", "master", "comm_error")


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
    engine's ``_resolve_model`` does, ``model.init(rng_seed)`` (BERT)."""

    def __init__(self, model=None, config=None, training_data=None, loss_fn=None,
                 params=None, rng_seed=0, device=None):
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
        self.zero_stage = self.config.zero_optimization_stage
        self.compute_dtype = (torch.bfloat16 if self.config.precision_dtype == "bfloat16"
                              else torch.float32)
        self._needs_master = self.compute_dtype != torch.float32
        self._health_cfg = self.config.health_check
        self._health_enabled = self._health_cfg.enabled
        if self.config.noop_keys_set:
            log_dist("config keys accepted but NO-OPs on one device: "
                     + ", ".join(self.config.noop_keys_set), ranks=[0])

        self.optimizer = self._configure_optimizer()
        self.lr_scheduler = self._configure_lr_scheduler()
        self._init_state(_to_master(params, self.device))

        self.training_dataloader = None
        self._data_iterator = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data)
            self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
        self._rng_seed = int(rng_seed)
        self._stream_step = 0             # monotonic data-stream batch index
        self.loaded_checkpoint_tag = None
        self.micro_steps = 0
        self.global_samples = 0
        self._global_steps = 0
        self._last_metrics = {}
        log_dist(f"DeepSpeedEngine ready: zero_stage={self.zero_stage} "
                 f"dtype={self.config.precision_dtype} device={self.device} "
                 f"micro_batch={self.train_micro_batch_size_per_gpu()} "
                 f"gas={self.gradient_accumulation_steps()}", ranks=[0])

    # ------------------------------------------------------------------ config
    def _configure_optimizer(self):
        name = self.config.optimizer_name
        if name is None:
            return DummyOptim()
        p = dict(self.config.optimizer_params or {})
        p.pop("torch_adam", None)        # accepted in reference configs; no-op
        if name == "adamw":
            p.pop("adam_w_mode", None)   # implied by the optimizer type
            return FusedAdamW(**p)
        return FusedAdam(**p)

    def _configure_lr_scheduler(self):
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

    # ------------------------------------------------------------------- state
    def _init_state(self, master):
        """fp32 master (16-bit training only), compute-dtype params, optimizer
        state over the fp32 base, device step counters, health EMA."""
        if self._needs_master:
            self.master = master
            self.params = tree_cast(master, self.compute_dtype)
        else:
            self.master = None
            self.params = master
        self.opt_state = self.optimizer.init(self._base)
        z = lambda: torch.zeros((), dtype=torch.int32, device=self.device)
        self._optimizer_steps, self._skipped_steps = z(), z()
        self.health = hmod.init_state(self.device) if self._health_enabled else None

    @property
    def _base(self):
        """What the optimizer updates: the fp32 master, or the fp32 params."""
        return self.master if self._needs_master else self.params

    # -------------------------------------------------------------- train step
    def _grad_fn(self, base, batch, seed):
        """fp32 gradients of ``mean loss`` w.r.t. ``base`` over the ``gas``
        microbatches of ``batch`` (leaves shaped (gas, micro, ...)),
        through the cast to the compute dtype.  Returns ``(grads, loss)``."""
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
                scaled = self._loss_fn(p, mb, _fold(seed, i)) / gas
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
        """Gradients, clipped by global norm, and the step's metrics."""
        grads, loss = self._grad_fn(base, batch, seed)
        if self.config.gradient_clipping > 0:
            grads, gnorm = clip_by_global_norm(grads, self.config.gradient_clipping)
        else:
            gnorm = global_norm(grads)
        lr = self._lr_at(self._global_steps)
        return grads, lr, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    def _health_sentinels(self, loss, grads):
        """``(skip, new_health, metrics)``: the device flags gating the step."""
        cfg = self._health_cfg
        nf_grads = hmod.tree_nonfinite(grads)
        nf_loss = ~torch.isfinite(loss)
        new_health, z, spike = hmod.update_ema(self.health, loss,
                                               window=cfg.spike_window, zmax=cfg.spike_zmax)
        skip = torch.zeros((), dtype=torch.bool, device=self.device)
        if cfg.skip_nonfinite:
            skip = skip | nf_grads | nf_loss
        if cfg.skip_on_spike:
            skip = skip | spike
        return skip, new_health, {"nonfinite_grads": nf_grads, "nonfinite_loss": nf_loss,
                                  "health_z": z, "loss_spike": spike}

    def _train_step(self, batch, seed):
        """One optimizer step over the gas microbatches of ``batch``,
        committed in place (a ``where`` no-op when skipped)."""
        base = self._base
        grads, lr, metrics = self._grads_and_metrics(base, batch, seed)
        with torch.no_grad():
            skip = torch.zeros((), dtype=torch.bool, device=self.device)
            if self._health_enabled:
                skip, self.health, sm = self._health_sentinels(metrics["loss"], grads)
                metrics.update(sm)
            new_base, new_opt = self.optimizer.update(
                grads, self.opt_state, base, step=self._optimizer_steps + 1, lr=lr)
            del grads
            if self._health_enabled and self._health_cfg.skip_nonfinite:
                nf_params = hmod.tree_nonfinite(new_base)
                skip = skip | nf_params
                metrics["nonfinite_params"] = nf_params
            gate = self._health_enabled and (self._health_cfg.skip_nonfinite
                                             or self._health_cfg.skip_on_spike)
            commit = ((lambda old, new: old.copy_(torch.where(skip, old, new))) if gate
                      else (lambda old, new: old.copy_(new)))
            tree_map(commit, base, new_base)
            tree_map(commit, self.opt_state, new_opt)
            if self._needs_master:
                tree_map(lambda p, m: p.copy_(m), self.params, self.master)
            skip_i = skip.int()
            self._optimizer_steps += 1 - skip_i
            self._skipped_steps += skip_i
        metrics["skip"] = skip
        return metrics

    # ------------------------------------------------------------- public API
    def train_batch(self, data_iter=None):
        """One training step (gas microbatches → one optimizer step);
        returns the step's mean loss as a 0-dim device tensor."""
        fault.site("engine.step")        # host-side only
        it = data_iter if data_iter is not None else self._data_iterator
        if it is None:
            raise ValueError("train_batch needs training_data or a data_iter")
        micro_batches = [next(it) for _ in range(self.gradient_accumulation_steps())]
        # this step's data-stream position: checkpointed with the loader
        # state, and the index the value faults key on
        index = self._stream_step
        self._stream_step += 1
        if fault.is_enabled():
            micro_batches = [fault.corrupt_batch(mb, index) for mb in micro_batches]
        batch = self._stack_microbatches(micro_batches)
        metrics = self._train_step(batch, _fold(self._rng_seed, self.micro_steps))
        return self._finish_step(metrics)

    def _stack_microbatches(self, micro_batches):
        """Host microbatches → one device tree with a leading gas axis."""
        return tree_map(lambda *xs: torch.from_numpy(np.stack(
            [np.asarray(x) for x in xs])).to(self.device), *micro_batches)

    def _finish_step(self, metrics):
        self._last_metrics = metrics
        self.micro_steps += self.gradient_accumulation_steps()
        self.global_samples += self.train_batch_size()
        self._global_steps += 1
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self._global_steps % self.config.steps_per_print == 0:
            # the only host read of a step, on reporting steps
            msg = (f"step={self._global_steps}, loss={float(metrics['loss']):.6f}, "
                   f"lr={metrics['lr']:.3e}")
            if self._health_enabled and bool(metrics["skip"]):
                msg += f", SKIPPED (health sentinel; total {self.skipped_steps})"
            log_dist(msg, ranks=[0])
        return metrics["loss"]

    def eval_batch(self, batch, rng=None):
        """The loss of ``batch`` (host arrays) without gradients or update."""
        batch = tree_map(lambda a: torch.as_tensor(np.asarray(a)).to(self.device), batch)
        with torch.no_grad():
            return self._loss_fn(self.params, batch, 0 if rng is None else int(rng))

    def deepspeed_io(self, dataset):
        """The config-driven loader (micro-batches of
        ``train_micro_batch_size_per_gpu`` samples)."""
        return DeepSpeedDataLoader(dataset, batch_size=self.train_micro_batch_size_per_gpu(),
                                   drop_last=self.config.dataloader_drop_last)

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
        A failed write raises after the ``io_retry`` policy."""
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
        save_tree(os.path.join(path, MODEL_FILE), {"params": self.params},
                  meta=self._engine_meta(client_state), fsync=False, retry=retry)
        fault.site("ckpt.after_model_file")
        optim_tree = {"opt_state": self.opt_state}
        if self.master is not None:
            optim_tree["master"] = self.master
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
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        save_tree(path, {"params": self.params}, meta={"dtype": self.config.precision_dtype},
                  fsync=fsync, retry=retry)
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

    def load_checkpoint(self, load_dir, tag=None, load_module_only=False,
                        load_optimizer_states=True, load_lr_scheduler_states=True):
        """Load a manifest-verified checkpoint into the engine's tensors in
        place (JAX :2465).  Returns ``(path, client_state)``."""
        tag = self._resolve_checkpoint_tag(load_dir, tag)
        path = self._get_ckpt_name(load_dir, tag)
        retry = self.config.io_retry_config.policy()
        model_tree, meta = load_tree(os.path.join(path, MODEL_FILE), with_meta=True,
                                     retry=retry)
        self._check_mesh_transition(meta)
        optim_tree = None
        if load_optimizer_states and not load_module_only:
            optim_tree = load_tree(os.path.join(path, OPTIM_FILE), retry=retry)
            if "scale" in optim_tree:
                raise NotImplementedError("checkpoint optimizer key 'scale' (the fp16 loss "
                                          "scaler) is not ported")
            extra = sorted(set(optim_tree) - set(OPTIM_TREES))
            if extra:
                raise NotImplementedError(f"checkpoint optimizer keys {extra} are not ported")
        self.loaded_checkpoint_tag = tag
        loaded_params = restore_like(self.params, model_tree["params"])
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
            # comm_error (qgZ error feedback) is ignored: this engine keeps none
        self._global_steps = int(meta["global_steps"])
        self._optimizer_steps.fill_(int(meta["optimizer_steps"]))
        self._skipped_steps.fill_(int(meta["skipped_steps"]))
        if self.health is not None:
            # a fresh EMA: the loaded run must not inherit the loss statistics
            # of the steps just discarded (init_state's zeros, in place)
            for t in self.health:
                t.zero_()
        self.micro_steps = meta.get("micro_steps", 0)
        self.global_samples = meta.get("global_samples", 0)
        data_state = meta.get("data_state") or {}
        self._stream_step = int(data_state.get("stream_step", 0))
        if data_state.get("loader") is not None and self.training_dataloader is not None:
            self.training_dataloader.load_state_dict(data_state["loader"])
            self._data_iterator = iter(RepeatingLoader(self.training_dataloader))
        if (load_lr_scheduler_states and self.lr_scheduler is not None
                and meta.get("lr_scheduler") is not None):
            self.lr_scheduler.load_state_dict(meta["lr_scheduler"])
        log_dist(f"loaded checkpoint {path} at global_step={meta['global_steps']}", ranks=[0])
        return path, meta.get("client_state", {})
