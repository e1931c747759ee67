"""DeepSpeed JSON config of the port's training slice.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (``DeepSpeedConfig``)
over the same JSON dicts.  Resolved here: the batch triple
(``_configure_train_batch_size`` / ``_batch_assertion``, at world size
1), the ``bf16`` block and the ``fp16`` block (``DeepSpeedFP16Config``:
the dynamic or static loss scaler), ``optimizer``, ``scheduler``,
``gradient_clipping``, ``steps_per_print``, ``dataloader_drop_last``,
``data_types.grad_accum_dtype``, ``zero_optimization`` (stages 0-3 and
the optimizer offload block to the host or NVMe, ``zero/config.py``), the
``aio`` block (JAX ``AIO_DEFAULT_DICT`` updated by the section,
``config.py:887-888``), the
``activation_checkpointing`` block (JAX ``config.py:82-100``, read by
``activation_checkpointing/checkpointing.py``'s ``configure``), the
``checkpoint`` and ``io_retry`` blocks (``DeepSpeedCheckpointConfig`` /
``DeepSpeedIORetryConfig``, JAX ``config.py:873-874``), the
``health_check`` block (the device sentinels and the host escalation
ladder, with JAX's validation and its ``DSTPU_HEALTH_CHECK`` override of
``enabled``), ``sparse_attention`` (the
JSON section as a dict, default ``None``, as ``config.py:886`` stores it;
the caller builds the layout with ``build_sparsity_config``), and the
``curriculum_learning`` and ``progressive_layer_drop`` blocks
(``DeepSpeedCurriculumConfig`` / ``DeepSpeedPLDConfig``, JAX
``config.py:258-271``: the same keys and defaults).

``sparse_gradients`` (JAX ``sparse_gradients_enabled``, the offload
wire's row-sparse leaves) is parsed.

What the port does not run raises ``NotImplementedError`` instead of
being ignored: world size > 1,
``fp16.master_weights_and_grads`` (a no-op key in the JAX package, whose
fp32 master is unconditional), an optimizer other than Adam, AdamW, Lamb,
SGD and Adagrad
(the 1-bit ones), and every other block of the JAX config surface (monitor,
compile cache, comms compression, eigenvalue, ...) set to
anything but off.  So is a key the JAX package does not
know.  ``prescale_gradients`` / ``gradient_predivide_factor`` and the
ZeRO bucketing keys are accepted as no-ops, as in the JAX package, and
listed in ``noop_keys_set``.

Differences: a batch triple that does not multiply out raises
``DeepSpeedConfigError`` (the JAX package uses ``assert``); a
``sparse_attention`` section is validated at parse time through
``build_sparsity_config`` (an unknown mode raises ``ValueError``, a bad
parameter the config class's own error), where the JAX package only
stores it.
"""

from . import constants as C
from .config_utils import load_config_dict
from .zero.config import DeepSpeedZeroConfig

PORTED_KEYS = {
    C.TRAIN_BATCH_SIZE, C.TRAIN_MICRO_BATCH_SIZE_PER_GPU,
    C.GRADIENT_ACCUMULATION_STEPS, C.STEPS_PER_PRINT, C.OPTIMIZER, C.SCHEDULER,
    C.FP16, C.BFLOAT16, C.BFLOAT16_OLD, C.GRADIENT_CLIPPING,
    C.PRESCALE_GRADIENTS, C.GRADIENT_PREDIVIDE_FACTOR, C.DATA_TYPES,
    C.DATALOADER_DROP_LAST, C.ZERO_OPTIMIZATION, C.HEALTH_CHECK, C.SPARSE_ATTENTION,
    C.CHECKPOINT, C.IO_RETRY, C.CURRICULUM_LEARNING, C.PROGRESSIVE_LAYER_DROP,
    C.ACTIVATION_CHECKPOINTING, C.AIO, C.SPARSE_GRADIENTS,
}


class DeepSpeedConfigError(Exception):
    pass


def _is_off(value, off):
    if isinstance(off, dict):
        return isinstance(value, dict) and all(
            k == "enabled" and not v for k, v in value.items())
    return value == off


class DeepSpeedFP16Config:
    """``fp16`` (JAX ``config.py:49-70``): the same keys and defaults;
    ``loss_scale == 0`` means dynamic scaling from
    ``2**initial_scale_power``.  ``master_weights_and_grads`` set raises
    ``NotImplementedError`` (the port keeps an fp32 master, as JAX does,
    and runs nothing else)."""

    def __init__(self, param_dict):
        fp16_dict = param_dict.get(C.FP16) or {}
        get = lambda key, default: fp16_dict.get(key, default)  # noqa: E731
        self.enabled = get(C.FP16_ENABLED, C.FP16_ENABLED_DEFAULT)
        self.loss_scale = get(C.FP16_LOSS_SCALE, C.FP16_LOSS_SCALE_DEFAULT)
        self.initial_scale_power = get(C.FP16_INITIAL_SCALE_POWER,
                                       C.FP16_INITIAL_SCALE_POWER_DEFAULT)
        self.loss_scale_window = get(C.FP16_LOSS_SCALE_WINDOW, C.FP16_LOSS_SCALE_WINDOW_DEFAULT)
        self.hysteresis = get(C.FP16_HYSTERESIS, C.FP16_HYSTERESIS_DEFAULT)
        self.min_loss_scale = get(C.FP16_MIN_LOSS_SCALE, C.FP16_MIN_LOSS_SCALE_DEFAULT)
        self.master_weights_and_grads = get(
            "master_weights_and_grads",
            param_dict.get(C.FP16_MASTER_WEIGHTS_AND_GRADS,
                           C.FP16_MASTER_WEIGHTS_AND_GRADS_DEFAULT))
        if self.master_weights_and_grads:
            raise NotImplementedError("fp16.master_weights_and_grads is not ported")

    @property
    def dynamic_loss_scale(self):
        return self.loss_scale == 0


class DeepSpeedHealthCheckConfig:
    """``health_check`` (JAX ``config.py:396-463``): the device sentinels
    (``skip_nonfinite``, the EMA loss-spike z-score) drive the branchless
    skip-step, and the host ladder (``runtime/health.py``'s
    ``HealthMonitor``) escalates a run of ``consecutive_skip_budget``
    skips to a rewind, and ``rewind_limit`` spent rewinds to
    ``on_exhausted`` (abort with forensics, or warn).  The same keys,
    defaults and checks; ``DSTPU_HEALTH_CHECK`` overrides ``enabled``
    either way."""

    def __init__(self, param_dict):
        import os
        h = param_dict.get(C.HEALTH_CHECK) or {}
        unknown = sorted(set(h) - set(C.HEALTH_DEFAULTS))
        if unknown:
            raise DeepSpeedConfigError(f"health_check: unknown keys {unknown}")
        get = lambda k: h.get(k, C.HEALTH_DEFAULTS[k])  # noqa: E731
        self.enabled = bool(get("enabled"))
        env = os.environ.get(C.HEALTH_CHECK_ENV)
        if env:
            self.enabled = env.lower() in ("1", "true", "yes")
        self.skip_nonfinite = bool(get("skip_nonfinite"))
        self.spike_window = int(get("spike_window"))
        self.spike_zmax = float(get("spike_zmax"))
        self.skip_on_spike = bool(get("skip_on_spike"))
        self.consecutive_skip_budget = int(get("consecutive_skip_budget"))
        self.rewind_limit = int(get("rewind_limit"))
        self.on_exhausted = get("on_exhausted")
        self.check_interval = int(get("check_interval"))
        self.history = int(get("history"))
        self.forensic_dir = get("forensic_dir")
        if self.spike_window < 2:
            raise DeepSpeedConfigError("health_check.spike_window must be >= 2")
        if self.spike_zmax < 0:
            raise DeepSpeedConfigError("health_check.spike_zmax must be >= 0")
        if self.skip_on_spike and self.spike_zmax <= 0:
            raise DeepSpeedConfigError("health_check.skip_on_spike needs spike_zmax > 0")
        if self.consecutive_skip_budget < 0:
            raise DeepSpeedConfigError("health_check.consecutive_skip_budget must be >= 0")
        if self.rewind_limit < 0:
            raise DeepSpeedConfigError("health_check.rewind_limit must be >= 0")
        if self.on_exhausted not in C.HEALTH_ON_EXHAUSTED_MODES:
            raise DeepSpeedConfigError(f"health_check.on_exhausted must be one of "
                                       f"{C.HEALTH_ON_EXHAUSTED_MODES}")
        if self.check_interval < 1:
            raise DeepSpeedConfigError("health_check.check_interval must be >= 1")
        if self.history < 1:
            raise DeepSpeedConfigError("health_check.history must be >= 1")


class DeepSpeedCheckpointConfig:
    """``checkpoint`` (JAX ``config.py:323``): ``keep_n``, ``verify``,
    ``auto_resume``, ``dir`` and ``fsync`` drive the engine's save / load
    and ``initialize``'s auto-resume.  Difference: the JAX package stores
    ``tag_validation`` and ``load_universal`` and reads neither (the
    reference's cross-rank tag check, the universal checkpoint format);
    the port validates them the same way, then raises
    ``NotImplementedError`` for any value but the default."""

    def __init__(self, param_dict):
        ckpt = param_dict.get(C.CHECKPOINT, {}) or {}
        self.tag_validation = ckpt.get(C.CHECKPOINT_TAG_VALIDATION,
                                       C.CHECKPOINT_TAG_VALIDATION_DEFAULT)
        if self.tag_validation not in C.CHECKPOINT_TAG_VALIDATION_MODES:
            raise DeepSpeedConfigError("checkpoint.tag_validation must be one of "
                                       f"{C.CHECKPOINT_TAG_VALIDATION_MODES}")
        self.load_universal = ckpt.get(C.LOAD_UNIVERSAL_CHECKPOINT,
                                       C.LOAD_UNIVERSAL_CHECKPOINT_DEFAULT)
        if self.tag_validation != C.CHECKPOINT_TAG_VALIDATION_DEFAULT or self.load_universal:
            raise NotImplementedError("checkpoint.tag_validation / load_universal are not "
                                      "run; they may only keep their defaults")
        keep_n = ckpt.get(C.CHECKPOINT_KEEP_N, C.CHECKPOINT_KEEP_N_DEFAULT)
        keep_n = 0 if keep_n is None else int(keep_n)
        if keep_n < 0:
            raise DeepSpeedConfigError("checkpoint.keep_n must be >= 0")
        self.keep_n = keep_n
        self.verify = ckpt.get(C.CHECKPOINT_VERIFY, C.CHECKPOINT_VERIFY_DEFAULT)
        if self.verify not in C.CHECKPOINT_VERIFY_MODES:
            raise DeepSpeedConfigError(
                f"checkpoint.verify must be one of {C.CHECKPOINT_VERIFY_MODES}")
        self.auto_resume = ckpt.get(C.CHECKPOINT_AUTO_RESUME, C.CHECKPOINT_AUTO_RESUME_DEFAULT)
        self.dir = ckpt.get(C.CHECKPOINT_DIR, C.CHECKPOINT_DIR_DEFAULT)
        self.fsync = ckpt.get(C.CHECKPOINT_FSYNC, C.CHECKPOINT_FSYNC_DEFAULT)


class DeepSpeedIORetryConfig:
    """``io_retry`` (JAX ``config.py:354``): the bounded backoff of
    checkpoint IO (``utils/retry.py``)."""

    def __init__(self, param_dict):
        r = param_dict.get(C.IO_RETRY, {}) or {}
        self.max_attempts = int(r.get(C.IO_RETRY_MAX_ATTEMPTS, C.IO_RETRY_MAX_ATTEMPTS_DEFAULT))
        self.base_delay_s = float(r.get(C.IO_RETRY_BASE_DELAY_S,
                                        C.IO_RETRY_BASE_DELAY_S_DEFAULT))
        self.max_delay_s = float(r.get(C.IO_RETRY_MAX_DELAY_S, C.IO_RETRY_MAX_DELAY_S_DEFAULT))
        self.jitter = float(r.get(C.IO_RETRY_JITTER, C.IO_RETRY_JITTER_DEFAULT))
        self.full_jitter = bool(r.get(C.IO_RETRY_FULL_JITTER, C.IO_RETRY_FULL_JITTER_DEFAULT))
        self.max_elapsed_s = r.get(C.IO_RETRY_MAX_ELAPSED_S, C.IO_RETRY_MAX_ELAPSED_S_DEFAULT)
        if self.max_attempts < 1:
            raise DeepSpeedConfigError("io_retry.max_attempts must be >= 1")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise DeepSpeedConfigError("io_retry.base_delay_s/max_delay_s must be >= 0")
        if not 0.0 <= self.jitter < 1.0:
            raise DeepSpeedConfigError("io_retry.jitter must be in [0, 1)")
        if self.max_elapsed_s is not None:
            self.max_elapsed_s = float(self.max_elapsed_s)
            if self.max_elapsed_s <= 0:
                raise DeepSpeedConfigError("io_retry.max_elapsed_s must be > 0 (or absent)")

    def policy(self, **overrides):
        from ..utils.retry import RetryPolicy
        kw = dict(max_attempts=self.max_attempts, base_delay_s=self.base_delay_s,
                  max_delay_s=self.max_delay_s, jitter=self.jitter,
                  jitter_mode="full" if self.full_jitter else "proportional",
                  max_elapsed_s=self.max_elapsed_s)
        kw.update(overrides)
        return RetryPolicy(**kw)


def _world_size():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


class DeepSpeedCurriculumConfig:
    """``curriculum_learning``: ``enabled`` and the whole block as
    ``params`` (``CurriculumScheduler``'s config), as JAX keeps it."""

    def __init__(self, param_dict):
        cl_dict = param_dict.get(C.CURRICULUM_LEARNING) or {}
        self.enabled = cl_dict.get(C.CURRICULUM_ENABLED, C.CURRICULUM_ENABLED_DEFAULT)
        self.params = dict(cl_dict)


class DeepSpeedPLDConfig:
    """``progressive_layer_drop``: ``enabled``, ``theta``, ``gamma``."""

    def __init__(self, param_dict):
        pld_dict = param_dict.get(C.PROGRESSIVE_LAYER_DROP) or {}
        self.enabled = pld_dict.get(C.PLD_ENABLED, C.PLD_ENABLED_DEFAULT)
        self.theta = pld_dict.get(C.PLD_THETA, C.PLD_THETA_DEFAULT)
        self.gamma = pld_dict.get(C.PLD_GAMMA, C.PLD_GAMMA_DEFAULT)


class DeepSpeedActivationCheckpointingConfig:
    """``activation_checkpointing`` (JAX ``config.py:82-100``): the same
    keys and defaults; ``activation_checkpointing.checkpointing.configure``
    reads them."""

    KEYS = ("partition_activations", "contiguous_memory_optimization", "cpu_checkpointing",
            "number_checkpoints", "synchronize_checkpoint_boundary", "profile")

    def __init__(self, param_dict):
        a = param_dict.get(C.ACTIVATION_CHECKPOINTING) or {}
        unknown = sorted(set(a) - set(self.KEYS))
        if unknown:
            raise DeepSpeedConfigError(f"activation_checkpointing: unknown keys {unknown}")
        self.partition_activations = a.get("partition_activations", False)
        self.contiguous_memory_optimization = a.get("contiguous_memory_optimization", False)
        self.cpu_checkpointing = a.get("cpu_checkpointing", False)
        self.number_checkpoints = a.get("number_checkpoints", None)
        self.synchronize_checkpoint_boundary = a.get("synchronize_checkpoint_boundary", False)
        self.profile = a.get("profile", False)


class DeepSpeedConfig:
    """Parse and validate the JSON config document (world size 1; an
    initialised process group of more ranks raises)."""

    def __init__(self, config):
        world_size = _world_size()
        if world_size != 1:
            raise NotImplementedError(f"world size {world_size}: only one device is "
                                      "ported (ZeRO across ranks and sparse_allreduce: "
                                      "ROADMAP item 9)")
        self._param_dict = dict(load_config_dict(config))
        self._check_unported(self._param_dict)
        self._initialize_params(self._param_dict)
        self._configure_train_batch_size()

    @staticmethod
    def _check_unported(pd):
        for key, value in pd.items():
            if key in PORTED_KEYS:
                continue
            if key not in C.UNPORTED:
                raise NotImplementedError(f"config key {key!r} is unknown or not ported")
            if not _is_off(value, C.UNPORTED[key]):
                why = f" ({C.UNPORTED_WHY[key]})" if key in C.UNPORTED_WHY else ""
                raise NotImplementedError(f"config block {key!r} is not ported{why}; it "
                                          f"may only be absent or off, got {value!r}")

    def _initialize_params(self, pd):
        self.train_batch_size = pd.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = pd.get(C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = pd.get(C.GRADIENT_ACCUMULATION_STEPS)
        self.steps_per_print = pd.get(C.STEPS_PER_PRINT, C.STEPS_PER_PRINT_DEFAULT)
        self.gradient_clipping = pd.get(C.GRADIENT_CLIPPING, C.GRADIENT_CLIPPING_DEFAULT)
        self.dataloader_drop_last = pd.get(C.DATALOADER_DROP_LAST,
                                           C.DATALOADER_DROP_LAST_DEFAULT)
        dt = pd.get(C.DATA_TYPES) or {}
        self.grad_accum_dtype = dt.get(C.GRAD_ACCUM_DTYPE, C.GRAD_ACCUM_DTYPE_DEFAULT)
        if set(dt) - {C.GRAD_ACCUM_DTYPE} or self.grad_accum_dtype not in ("fp32", "bf16"):
            raise DeepSpeedConfigError(f"data_types must be {{'grad_accum_dtype': "
                                       f"'fp32'|'bf16'}}, got {dt!r}")
        self.noop_keys_set = [k for k in (C.PRESCALE_GRADIENTS, C.GRADIENT_PREDIVIDE_FACTOR)
                              if k in pd]

        self.optimizer_name = self.optimizer_params = None
        opt = pd.get(C.OPTIMIZER)
        if opt is not None:
            self.optimizer_name = opt.get(C.TYPE)
            if self.optimizer_name is not None:
                self.optimizer_name = self.optimizer_name.lower()
            self.optimizer_params = opt.get(C.OPTIMIZER_PARAMS, {})
            if self.optimizer_name not in (None, C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER,
                                           C.LAMB_OPTIMIZER, C.SGD_OPTIMIZER,
                                           C.ADAGRAD_OPTIMIZER):
                raise NotImplementedError(f"optimizer {opt.get(C.TYPE)!r}: only Adam, "
                                          "AdamW, Lamb, SGD and Adagrad are ported")
        self.scheduler_name = self.scheduler_params = None
        sched = pd.get(C.SCHEDULER)
        if sched is not None:
            self.scheduler_name = sched.get(C.TYPE)
            self.scheduler_params = sched.get(C.SCHEDULER_PARAMS, {})

        self.zero_config = DeepSpeedZeroConfig(pd)
        self.noop_keys_set += [f"zero_optimization.{k}" for k in self.zero_config.noop_keys_set]
        self.fp16 = DeepSpeedFP16Config(pd)
        self.fp16_enabled = bool(self.fp16.enabled)
        bf16 = pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD)) or {}
        self.bf16_enabled = bool(bf16.get("enabled", False))
        if self.fp16_enabled and self.bf16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        self.health_check = DeepSpeedHealthCheckConfig(pd)
        self.aio_config = dict(C.AIO_DEFAULT_DICT)
        self.aio_config.update(pd.get(C.AIO) or {})
        self.checkpoint_config = DeepSpeedCheckpointConfig(pd)
        self.io_retry_config = DeepSpeedIORetryConfig(pd)
        self.curriculum = DeepSpeedCurriculumConfig(pd)
        self.pld = DeepSpeedPLDConfig(pd)
        self.activation_checkpointing = DeepSpeedActivationCheckpointingConfig(pd)
        self.progressive_layer_drop = self.pld   # the reference's name
        self.sparse_gradients_enabled = bool(pd.get(C.SPARSE_GRADIENTS,
                                                    C.SPARSE_GRADIENTS_DEFAULT))
        self.sparse_attention = pd.get(C.SPARSE_ATTENTION)
        if self.sparse_attention is not None:
            if not isinstance(self.sparse_attention, dict):
                raise DeepSpeedConfigError("sparse_attention must be a dict section, got "
                                           f"{self.sparse_attention!r}")
            from ..ops.sparse_attention.sparsity_config import build_sparsity_config
            try:
                build_sparsity_config(self.sparse_attention, num_heads=1)
            except TypeError as e:       # a key the mode's config class does not take
                raise DeepSpeedConfigError(f"sparse_attention: {e}") from e

    def _configure_train_batch_size(self):
        """Solve for the missing one of (train_batch, micro_batch, gas), at
        world size 1."""
        train_batch = self.train_batch_size
        micro_batch = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        if train_batch is not None and micro_batch is not None and gas is not None:
            pass
        elif train_batch is not None and micro_batch is not None:
            gas = train_batch // micro_batch
        elif train_batch is not None and gas is not None:
            micro_batch = train_batch // gas
        elif micro_batch is not None and gas is not None:
            train_batch = micro_batch * gas
        elif train_batch is not None:
            gas, micro_batch = 1, train_batch
        elif micro_batch is not None:
            train_batch, gas = micro_batch, 1
        else:
            raise DeepSpeedConfigError("Either train_batch_size or "
                                       "train_micro_batch_size_per_gpu needs to be provided")
        self.train_batch_size = train_batch
        self.train_micro_batch_size_per_gpu = micro_batch
        self.gradient_accumulation_steps = gas
        if not (train_batch > 0 and micro_batch > 0 and gas > 0
                and train_batch == micro_batch * gas):
            raise DeepSpeedConfigError(
                f"Check batch related parameters: train_batch_size {train_batch} must be "
                f"micro_batch_per_gpu {micro_batch} * gradient_acc_step {gas} * "
                f"world_size 1, all > 0")

    @property
    def zero_optimization_stage(self):
        return self.zero_config.stage

    @property
    def zero_enabled(self):
        return self.zero_config.stage > 0

    @property
    def precision_dtype(self):
        """Compute dtype implied by the config ('bfloat16'|'float16'|'float32')."""
        if self.bf16_enabled:
            return "bfloat16"
        if self.fp16_enabled:
            return "float16"
        return "float32"
