"""DeepSpeed JSON config of the port's training slice.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (``DeepSpeedConfig``)
over the same JSON dicts.  Resolved here: the batch triple
(``_configure_train_batch_size`` / ``_batch_assertion``, at world size
1), the ``bf16``/``fp16`` blocks, ``optimizer``, ``scheduler``,
``gradient_clipping``, ``steps_per_print``, ``dataloader_drop_last``,
``data_types.grad_accum_dtype``, ``zero_optimization.stage``, the
``checkpoint`` and ``io_retry`` blocks (``DeepSpeedCheckpointConfig`` /
``DeepSpeedIORetryConfig``, JAX ``config.py:873-874``), the
``health_check`` block's device sentinels and ``sparse_attention`` (the
JSON section as a dict, default ``None``, as ``config.py:886`` stores it;
the caller builds the layout with ``build_sparsity_config``).

What the port does not run raises ``NotImplementedError`` instead of
being ignored: world size > 1, ZeRO stage 3 and offload, ``fp16``
(the loss scaler), an optimizer other than Adam/AdamW, the health
guardian's host escalation ladder, and every other block of the JAX
config surface (monitor, compile cache, comms compression, curriculum,
PLD, ...) set to anything but off.  So is a key the JAX package does not
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
    C.CHECKPOINT, C.IO_RETRY,
}


class DeepSpeedConfigError(Exception):
    pass


def _is_off(value, off):
    if isinstance(off, dict):
        return isinstance(value, dict) and all(
            k == "enabled" and not v for k, v in value.items())
    return value == off


class DeepSpeedHealthCheckConfig:
    """``health_check``: the device sentinels (``skip_nonfinite``, the EMA
    loss-spike z-score) drive the branchless skip-step; the host ladder
    keys (rewind / abort) raise when set to anything but their default."""

    def __init__(self, param_dict):
        h = param_dict.get(C.HEALTH_CHECK) or {}
        unknown = sorted(set(h) - set(C.HEALTH_DEFAULTS))
        if unknown:
            raise DeepSpeedConfigError(f"health_check: unknown keys {unknown}")
        ladder = sorted(k for k in C.HEALTH_LADDER_KEYS
                        if k in h and h[k] != C.HEALTH_DEFAULTS[k])
        if ladder:
            raise NotImplementedError(f"health_check {ladder}: the host escalation "
                                      "ladder (rewind / abort) is not ported")
        get = lambda k: h.get(k, C.HEALTH_DEFAULTS[k])
        self.enabled = bool(get("enabled"))
        self.skip_nonfinite = bool(get("skip_nonfinite"))
        self.spike_window = int(get("spike_window"))
        self.spike_zmax = float(get("spike_zmax"))
        self.skip_on_spike = bool(get("skip_on_spike"))
        if self.spike_window < 2:
            raise DeepSpeedConfigError("health_check.spike_window must be >= 2")
        if self.spike_zmax < 0:
            raise DeepSpeedConfigError("health_check.spike_zmax must be >= 0")
        if self.skip_on_spike and self.spike_zmax <= 0:
            raise DeepSpeedConfigError("health_check.skip_on_spike needs spike_zmax > 0")


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


class DeepSpeedConfig:
    """Parse and validate the JSON config document (world size 1; an
    initialised process group of more ranks raises)."""

    def __init__(self, config):
        world_size = _world_size()
        if world_size != 1:
            raise NotImplementedError(f"world size {world_size}: only one device is "
                                      "ported (ZeRO across ranks comes later)")
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
                raise NotImplementedError(f"config block {key!r} is not ported; it may "
                                          f"only be absent or off, got {value!r}")

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
            if self.optimizer_name not in (None, C.ADAM_OPTIMIZER, C.ADAMW_OPTIMIZER):
                raise NotImplementedError(f"optimizer {opt.get(C.TYPE)!r}: only Adam and "
                                          "AdamW are ported")
        self.scheduler_name = self.scheduler_params = None
        sched = pd.get(C.SCHEDULER)
        if sched is not None:
            self.scheduler_name = sched.get(C.TYPE)
            self.scheduler_params = sched.get(C.SCHEDULER_PARAMS, {})

        self.zero_config = DeepSpeedZeroConfig(pd)
        self.noop_keys_set += [f"zero_optimization.{k}" for k in self.zero_config.noop_keys_set]
        fp16 = pd.get(C.FP16) or {}
        self.fp16_enabled = bool(fp16.get("enabled", False))
        bf16 = pd.get(C.BFLOAT16, pd.get(C.BFLOAT16_OLD)) or {}
        self.bf16_enabled = bool(bf16.get("enabled", False))
        if self.fp16_enabled and self.bf16_enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        if self.fp16_enabled:
            raise NotImplementedError("fp16 (the dynamic loss scaler) is not ported; "
                                      "use bf16")
        self.health_check = DeepSpeedHealthCheckConfig(pd)
        self.checkpoint_config = DeepSpeedCheckpointConfig(pd)
        self.io_retry_config = DeepSpeedIORetryConfig(pd)
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
        """'bfloat16' or 'float32' (fp16 raises at parse time)."""
        return "bfloat16" if self.bf16_enabled else "float32"
