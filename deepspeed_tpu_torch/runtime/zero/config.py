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
as JAX's assert does (``offload_engine.py:85-86``).  Parameter offload is
not ported: any ``offload_param`` block and ``cpu_offload_params`` raise
``NotImplementedError`` naming ROADMAP item 7c.  The bucketing and
overlap keys that the JAX package accepts as no-ops are accepted here
too and named by ``noop_keys_set``, as is the offload block's
``fast_init`` (JAX reads it for the streamed parameter tier only).
"""

ZERO_OPTIMIZATION = "zero_optimization"

OFFLOAD_DEVICE_NONE = "none"
OFFLOAD_DEVICE_CPU = "cpu"
OFFLOAD_DEVICE_NVME = "nvme"
PARAM_TIER = "ROADMAP item 7c: parameter offload and streaming"

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
               "gather_16bit_weights_on_model_save", "cpu_offload", "offload_optimizer")
# parameter offload and streaming (item 7c)
PARAM_KEYS = ("offload_param", "cpu_offload_params")


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


class DeepSpeedZeroConfig:
    """Parsed ``zero_optimization`` section: ``stage`` in 0..3, stage 3's
    keys and the optimizer offload block."""

    def __init__(self, param_dict=None):
        zero_dict = (param_dict or {}).get(ZERO_OPTIMIZATION, {})
        if isinstance(zero_dict, bool):
            # legacy: "zero_optimization": true meant stage 1
            zero_dict = {"stage": 1 if zero_dict else 0}
        self.stage = zero_dict.get("stage", 0)
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(f"Invalid ZeRO stage {self.stage}")
        param = sorted(k for k in PARAM_KEYS if k in zero_dict and zero_dict[k]
                       not in (None, False))
        if param:
            raise NotImplementedError(f"zero_optimization {param} is not ported ({PARAM_TIER})")
        unported = sorted(k for k in zero_dict
                          if k not in PARSED_KEYS and k not in NOOP_KEYS and k not in PARAM_KEYS)
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
        self.noop_keys_set = sorted(k for k in zero_dict if k in NOOP_KEYS) + (
            [f"offload_optimizer.{k}" for k in self.offload_optimizer.noop_keys]
            if self.offload_optimizer is not None else [])
