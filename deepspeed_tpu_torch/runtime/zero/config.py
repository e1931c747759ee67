"""ZeRO configuration of the port (counterpart of
``deepspeed_tpu/runtime/zero/config.py``).

On one device the placement of every stage is the same (nothing to
shard), so stages 0-3 are accepted and run the single-device step; stage
3's own keys (``sub_group_size``, ``stage3_param_persistence_threshold``
/ ``param_persistence_threshold``,
``stage3_gather_16bit_weights_on_model_save``) are parsed with the JAX
package's defaults.  The optimizer offload tier is ported, to the host
and to NVMe: ``offload_optimizer``
(:class:`DeepSpeedZeroOffloadOptimizerConfig`, the JAX class's keys and
defaults: ``device`` cpu or nvme, ``nvme_path``, ``buffer_count`` 4,
``pin_memory``, ``pipeline_read`` / ``pipeline_write``,
``delayed_param_update`` and ``delayed_param_update_warmup`` 20) and the
legacy ``cpu_offload`` flag, which means ``offload_optimizer:
{"device": "cpu"}`` as in JAX.  ``nvme`` without ``nvme_path`` raises,
as JAX's assert does (``offload_engine.py:85-86``).  Parameter offload
(``offload_param``, :class:`DeepSpeedZeroOffloadParamConfig`, JAX
``zero/config.py:43-65``: ``device`` cpu or nvme streams the layer
blocks through the card, ``runtime/zero/param_stream.py``); ``nvme``
without ``nvme_path`` raises, as JAX's assert in ``param_stream.py:155``
does, here at parse time.  ``cpu_offload_params``, which JAX parses
(``:132``) and never reads, is accepted with no effect (it does not mean
``offload_param: cpu``).  The bucketing and overlap keys that the JAX
package accepts as no-ops are accepted here too and named by
``noop_keys_set``, as are the offload blocks' keys JAX reads nothing of
(``offload_optimizer.fast_init``, ``offload_param.buffer_size`` /
``max_in_cpu``) and ``cpu_offload_params``.
"""

ZERO_OPTIMIZATION = "zero_optimization"

OFFLOAD_DEVICE_NONE = "none"
OFFLOAD_DEVICE_CPU = "cpu"
OFFLOAD_DEVICE_NVME = "nvme"

# accepted, with no effect on one device (the JAX package's NOOP_KEYS)
NOOP_KEYS = ("contiguous_gradients", "reduce_scatter", "reduce_bucket_size",
             "allgather_partitions", "allgather_bucket_size", "overlap_comm",
             "load_from_fp32_weights", "elastic_checkpoint",
             "ignore_unused_parameters", "round_robin_gradients", "legacy_stage1",
             "stage3_prefetch_bucket_size", "prefetch_bucket_size",
             "stage3_max_live_parameters", "max_live_parameters",
             "stage3_max_reuse_distance", "max_reuse_distance")
# parsed (JAX zero/config.py:121-161)
PARSED_KEYS = ("stage", "sub_group_size", "stage3_param_persistence_threshold",
               "param_persistence_threshold", "stage3_gather_16bit_weights_on_model_save",
               "gather_16bit_weights_on_model_save", "cpu_offload", "offload_optimizer",
               "offload_param")
# parsed as JAX parses them and read by nothing, in JAX as here
UNREAD_KEYS = ("cpu_offload_params",)


class DeepSpeedZeroOffloadOptimizerConfig:
    """``zero_optimization.offload_optimizer`` (JAX ``zero/config.py:67-103``):
    the same keys and defaults.  ``device`` "cpu" runs the host tier,
    "nvme" the host tier with the Adam moments in swap files under
    ``nvme_path`` (``runtime/zero/offload_engine.py``); ``pipeline`` is
    ``pipeline_read or pipeline_write``, as in JAX.  ``fast_init`` is
    accepted and listed in ``noop_keys``."""

    KEYS = ("device", "nvme_path", "buffer_count", "pin_memory", "pipeline_read",
            "pipeline_write", "delayed_param_update", "delayed_param_update_warmup")
    NOOP_KEYS = ("fast_init",)

    def __init__(self, param_dict=None):
        d = param_dict or {}
        unknown = sorted(set(d) - set(self.KEYS) - set(self.NOOP_KEYS))
        if unknown:
            raise NotImplementedError(f"offload_optimizer keys {unknown} are unknown")
        self.device = d.get("device", OFFLOAD_DEVICE_NONE)
        if self.device not in (OFFLOAD_DEVICE_NONE, OFFLOAD_DEVICE_CPU, OFFLOAD_DEVICE_NVME):
            raise ValueError(f"offload_optimizer.device must be none|cpu|nvme, "
                             f"got {self.device!r}")
        self.nvme_path = d.get("nvme_path")
        if self.device == OFFLOAD_DEVICE_NVME and not self.nvme_path:
            raise ValueError("offload_optimizer.device=nvme requires nvme_path")
        self.buffer_count = int(d.get("buffer_count", 4))
        self.pin_memory = bool(d.get("pin_memory", False))
        self.pipeline_read = bool(d.get("pipeline_read", False))
        self.pipeline_write = bool(d.get("pipeline_write", False))
        self.noop_keys = sorted(k for k in d if k in self.NOOP_KEYS)
        # one-step delayed parameter update (ZeRO-Offload's DPU): the device
        # computes step k+1's gradients while the host runs step k's update
        self.delayed_param_update = d.get("delayed_param_update", False)
        self.delayed_param_update_warmup = int(d.get("delayed_param_update_warmup", 20))

    @property
    def pipeline(self):
        return self.pipeline_read or self.pipeline_write


class DeepSpeedZeroOffloadParamConfig:
    """``zero_optimization.offload_param`` (JAX ``zero/config.py:43-65``):
    the same keys and defaults.  ``device`` "cpu" or "nvme" streams the
    layer blocks through the card (``runtime/zero/param_stream.py``; the
    16-bit layer payloads in files under ``nvme_path`` for "nvme"),
    ``buffer_count`` sizes the NVMe swapper's pool (at least 4, as in
    JAX), ``fast_init`` asks for the model's ``init_numpy``.
    ``buffer_size`` and ``max_in_cpu`` are parsed and, as in JAX, read by
    nothing (``noop_keys``); ``pin_memory`` likewise (the port's layer
    wire is always pinned on a card)."""

    KEYS = ("device", "nvme_path", "buffer_count", "fast_init")
    NOOP_KEYS = ("buffer_size", "max_in_cpu", "pin_memory")

    def __init__(self, param_dict=None):
        d = param_dict or {}
        unknown = sorted(set(d) - set(self.KEYS) - set(self.NOOP_KEYS))
        if unknown:
            raise NotImplementedError(f"offload_param keys {unknown} are unknown")
        self.device = d.get("device", OFFLOAD_DEVICE_NONE)
        if self.device not in (OFFLOAD_DEVICE_NONE, OFFLOAD_DEVICE_CPU, OFFLOAD_DEVICE_NVME):
            raise ValueError(f"offload_param.device must be none|cpu|nvme, got {self.device!r}")
        self.nvme_path = d.get("nvme_path")
        if self.device == OFFLOAD_DEVICE_NVME and not self.nvme_path:
            raise ValueError("offload_param.device=nvme needs nvme_path")
        self.buffer_count = int(d.get("buffer_count", 5))
        self.buffer_size = int(d.get("buffer_size", 1e8))
        self.max_in_cpu = int(d.get("max_in_cpu", 1e9))
        self.pin_memory = bool(d.get("pin_memory", False))
        self.fast_init = bool(d.get("fast_init", False))
        self.noop_keys = sorted(k for k in d if k in self.NOOP_KEYS)


class DeepSpeedZeroConfig:
    """Parsed ``zero_optimization`` section: ``stage`` in 0..3, stage 3's
    keys and the optimizer and parameter offload blocks."""

    def __init__(self, param_dict=None):
        zero_dict = (param_dict or {}).get(ZERO_OPTIMIZATION, {})
        if isinstance(zero_dict, bool):
            # legacy: "zero_optimization": true meant stage 1
            zero_dict = {"stage": 1 if zero_dict else 0}
        self.stage = zero_dict.get("stage", 0)
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(f"Invalid ZeRO stage {self.stage}")
        unported = sorted(k for k in zero_dict
                          if k not in PARSED_KEYS and k not in NOOP_KEYS and k not in UNREAD_KEYS)
        if unported:
            raise NotImplementedError(f"zero_optimization keys {unported} are not ported")
        self.sub_group_size = int(zero_dict.get("sub_group_size", 1e9))
        self.param_persistence_threshold = int(zero_dict.get(
            "stage3_param_persistence_threshold",
            zero_dict.get("param_persistence_threshold", 1e5)))
        self.gather_16bit_weights_on_model_save = zero_dict.get(
            "stage3_gather_16bit_weights_on_model_save",
            zero_dict.get("gather_16bit_weights_on_model_save", False))
        self.cpu_offload = zero_dict.get("cpu_offload", False)
        off = zero_dict.get("offload_optimizer")
        if off is None and self.cpu_offload:
            off = {"device": OFFLOAD_DEVICE_CPU}
        self.offload_optimizer = (DeepSpeedZeroOffloadOptimizerConfig(off)
                                  if off is not None else None)
        self.cpu_offload_params = zero_dict.get("cpu_offload_params", False)
        op = zero_dict.get("offload_param")
        self.offload_param = DeepSpeedZeroOffloadParamConfig(op) if op is not None else None
        self.noop_keys_set = sorted(k for k in zero_dict if k in NOOP_KEYS + UNREAD_KEYS)
        for name, block in (("offload_optimizer", self.offload_optimizer),
                            ("offload_param", self.offload_param)):
            if block is not None:
                self.noop_keys_set += [f"{name}.{k}" for k in block.noop_keys]

    def offload_optimizer_device(self):
        return (self.offload_optimizer.device if self.offload_optimizer is not None
                else OFFLOAD_DEVICE_NONE)

    def offload_param_device(self):
        return self.offload_param.device if self.offload_param is not None else OFFLOAD_DEVICE_NONE
