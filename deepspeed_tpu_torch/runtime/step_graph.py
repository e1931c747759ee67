"""A step captured once as a CUDA graph and replayed every step.

Counterpart of ``deepspeed_tpu/runtime/compile_cache.py:wrap_step``
(587-592) and ``InferenceEngine._wrap_step``
(``deepspeed_tpu/inference/engine.py:193-198``): where the JAX package
jits each serving and generate step into one executable, the port
captures the step's launches once per static shape into a
``torch.cuda.CUDAGraph`` and replays it, one host launch a step.

A :class:`StepGraph` owns

- its static input buffers on the device, refilled before each replay
  with ``copy_(..., non_blocking=True)`` from pinned host staging
  tensors, and the static outputs of the captured body;
- warm-up: the body runs on the pool's capture stream before capture, so
  every kernel library is built, every lazy cache filled and the int8
  kernels' tile counters (kept per stream) exist before capture begins;
- capture into the :class:`GraphPool`'s private memory pool, which an
  engine's graphs share: they never replay concurrently, and each
  graph's static outputs stay referenced by it;
- the launch bookkeeping.  The kernel modules count launches in Python
  (``launches`` of ``ops/transformer/{paged_attention,int8_matmul,
  flash_attention}.py``), and capture runs the Python once while nothing
  executes: the counters are snapshot before capture and restored after
  it, the difference is kept as the graph's launches, and each
  :meth:`StepGraph.__call__` that replays adds it.  Warm-up runs are real
  launches and count.  ``launches[k]`` keeps meaning "times kernel k ran
  on the card".

Without a pool (a CPU device, or an eager A/B run) there is no graph:
the body is called directly on the static buffers, as a kernel's plain
version stands in on the CPU.  On CUDA a capture or replay that fails
raises, naming the step; nothing falls back to eager execution.

Deliberate differences from ``wrap_step``: no persistent compile cache
(a graph lives as long as its engine), no donation (the pool and the
KV caches are updated in place at fixed addresses, which the captured
launches bake in), and shapes are fixed per graph by the caller
(``serving.py`` keys its prefill graphs by block bucket, as JAX keys
its executables).
"""

from typing import Callable, Dict, Optional

import numpy as np
import torch


def launch_counters():
    """The kernel modules' launch-count dicts, imported at call time."""
    from ..ops.transformer import flash_attention, int8_matmul, paged_attention
    return (flash_attention.launches, int8_matmul.launches, paged_attention.launches)


def _snapshot(counters):
    return [dict(c) for c in counters]


class GraphPool:
    """The private memory pool and the capture stream that an engine's
    graphs share.  ``graph_factory`` makes the graph objects: by default
    ``torch.cuda.CUDAGraph`` on a CUDA ``device``; any object with
    ``capture_begin(pool=...)``, ``capture_end()`` and ``replay()`` stands
    in for it (then no stream or pool handle is made)."""

    def __init__(self, device, graph_factory=None):
        self.device = torch.device(device)
        if graph_factory is None:
            if self.device.type != "cuda":
                raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
            self.graph_factory = torch.cuda.CUDAGraph
            self.handle = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        else:
            self.graph_factory = graph_factory
            self.handle = self.stream = None


class StepGraph:
    """``body(**inputs)`` as one captured step (see the module docstring).

    ``inputs``: name -> a tensor whose shape and dtype each call's value
    of that name takes; the static buffers start as copies of them on
    ``device``, and warm-up and capture run on those values (the serving
    steps pass tables whose every entry is the scratch block).  ``pool``:
    a :class:`GraphPool`, or None to call the body directly.  ``body``
    returns a tensor or a tuple of tensors, which every call returns: the
    same tensors (the static outputs) each replay."""

    def __init__(self, name: str, body: Callable, inputs: Dict[str, torch.Tensor],
                 device, pool: Optional[GraphPool] = None):
        self.name = name
        self.body = body
        self.device = torch.device(device)
        self.pool = pool
        self.static = {k: v.to(self.device, copy=True) for k, v in inputs.items()}
        pin = pool is not None and self.device.type == "cuda"
        self._staging = ({k: torch.zeros_like(v, device="cpu").pin_memory()
                          for k, v in self.static.items()} if pin else None)
        self._copied = None              # event after the last host-to-device copies
        self._graph = None
        self._outputs = None
        self._delta = []                 # (counter dict, {kernel: launches}) per replay
        self.captures = self.warmups = self.replays = 0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def prepare(self):
        """Warm up and capture now, on the static buffers' values, if a
        pool was given and nothing is captured yet (a caller whose body
        advances state it must reset first, as ``generate``'s cache)."""
        if self.pool is not None and self._graph is None:
            self._capture()

    def __call__(self, **values):
        if self.pool is None:
            self._fill(values)
            return self.body(**self.static)
        self.prepare()
        self._fill(values)
        try:
            self._graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"step {self.name}: CUDA graph replay failed: {e}") from e
        self.replays += 1
        for counter, d in self._delta:
            for k, n in d.items():
                counter[k] += n
        return self._outputs

    def _fill(self, values):
        if set(values) != set(self.static):
            raise ValueError(f"step {self.name} takes {sorted(self.static)}, "
                             f"got {sorted(values)}")
        if self._copied is not None:
            self._copied.synchronize()   # the last step's copies have left the staging
        for k, v in values.items():
            src = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            if self._staging is None:
                self.static[k].copy_(src.reshape(self.static[k].shape))
                continue
            self._staging[k].copy_(src.reshape(self._staging[k].shape))
            self.static[k].copy_(self._staging[k], non_blocking=True)
        if self._staging is not None:
            self._copied = torch.cuda.Event()
            self._copied.record()

    def _capture(self):
        pool = self.pool
        cuda = self.device.type == "cuda" and pool.stream is not None
        if cuda:
            pool.stream.wait_stream(torch.cuda.current_stream(self.device))
        counters = launch_counters()
        with torch.cuda.stream(pool.stream):
            self.body(**self.static)          # the warm-up: real launches, counted
            self.warmups += 1
            if cuda:
                torch.cuda.synchronize(self.device)
            before = _snapshot(counters)
            graph = pool.graph_factory()
            try:
                graph.capture_begin(pool=pool.handle)
                try:
                    outputs = self.body(**self.static)
                finally:
                    graph.capture_end()
            except RuntimeError as e:
                raise RuntimeError(f"step {self.name}: CUDA graph capture failed: {e}") from e
            finally:
                after = _snapshot(counters)
                for counter, snap in zip(counters, before):
                    counter.update(snap)
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(pool.stream)
        self._delta = [(c, {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)})
                       for c, b, a in zip(counters, before, after)]
        self._graph, self._outputs = graph, outputs
        self.captures += 1
