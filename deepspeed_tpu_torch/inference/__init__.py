"""Inference engine + continuous-batching serving layer of the port
(counterpart of ``deepspeed_tpu/inference/__init__.py``; the router,
journal and transfer queue are not ported yet)."""

from .engine import InferenceEngine
from .serving import (OK, OUTCOMES, POISONED, QueueFullError, Request,
                      ServingConfig, ServingEngine, ServingError,
                      ServingStalledError, SpeculativeConfig)

__all__ = ["InferenceEngine", "ServingEngine", "ServingConfig", "Request",
           "SpeculativeConfig", "ServingError", "QueueFullError",
           "ServingStalledError", "OK", "POISONED", "OUTCOMES"]
