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
  tensors (a value already on the device is copied directly), and the
  static outputs of the captured body;
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
its executables, and the training engine by micro-batch shapes and gas).

Capture also refuses what would be frozen into the graph: a host read of
a value on the step's device (``.item()``, ``int()``, ``bool()``) and a
copy between the host and the card raise :class:`HostTraffic`, naming
the op, under a ``TorchDispatchMode`` that is active during capture only
(the warm-up may fill host-built caches).  Python's garbage collector is
kept off during capture: an earlier engine's graph freed by a collection
inside a capture makes a call the capture forbids (``torch.cuda.graph``
collects before capture instead, which costs ~0.3 s a capture in a large
process, on a request's time to first token).  Each graph's pool bytes (what
the capture added to the allocator's reserved memory) are kept in
:attr:`StepGraph.pool_bytes`.

Dropout under capture.  A mask is drawn from a ``torch.Generator`` seeded
with a splitmix64 fold of the step's seed (``inference/engine.py``
``sample_seed``), which a replay cannot re-seed by itself.  A seeded step
(``StepGraph(..., seeded=True)``) passes its body a :class:`FoldedSeed`:
the step's base seed and the fold path below it, which the models extend
with :func:`fold` as they extend an int.  :func:`dropout_uniform` draws a
mask's uniforms: eagerly from a fresh generator seeded with the path's
value, as before; during the warm-up it also records each draw's path;
during capture the k-th draw takes the k-th of the step's persistent
generators, which were registered with the graph
(``CUDAGraph.register_generator_state``) before capture began.  Before
each replay every generator is re-seeded on the host with its path's
value under the new base seed (``manual_seed``, offset 0), which the
graph's replay prologue hands to the captured kernels.  So a mask is the
same pure function of (seed, path) eagerly, in a replay and in a remat
recompute (which draws again, from a generator of its own).
"""

import contextlib
import gc
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def launch_counters():
    """The kernel modules' launch-count dicts, imported at call time."""
    from ..ops.transformer import flash_attention, int8_matmul, paged_attention
    return (flash_attention.launches, int8_matmul.launches, paged_attention.launches)


def _snapshot(counters):
    return [dict(c) for c in counters]


# ------------------------------------------------------------- dropout seeds
class FoldedSeed:
    """A dropout seed as a path of folds below a step's base seed.
    :func:`fold` extends the path; :meth:`value` folds it down to the int
    the eager code would have used.  ``draws``: the seeded step's
    :class:`_Draws`, which every fold carries to the draws."""

    __slots__ = ("base", "path", "draws")

    def __init__(self, base, path=(), draws=None):
        self.base, self.path, self.draws = int(base), tuple(path), draws

    def fold(self, index):
        return FoldedSeed(self.base, self.path + (int(index),), self.draws)

    def value(self, base=None):
        from ..inference.engine import sample_seed
        v = self.base if base is None else int(base)
        for i in self.path:
            v = sample_seed(v, i)
        return v

    def __int__(self):
        if self.draws is not None and self.draws.mode == "capture":
            raise HostTraffic("a dropout seed read as an int during capture would be "
                              "frozen into the graph; draw through dropout_uniform")
        return self.value()

    def __repr__(self):
        return f"FoldedSeed({self.base}, {self.path})"


def fold(seed, index):
    """``sample_seed(seed, index)``; a :class:`FoldedSeed` one fold deeper."""
    if isinstance(seed, FoldedSeed):
        return seed.fold(index)
    from ..inference.engine import sample_seed
    return sample_seed(seed, index)


def as_seed(rng):
    """A model's ``rng`` argument as a seed: 0 for None, a
    :class:`FoldedSeed` kept as it is, else an int."""
    if rng is None:
        return 0
    return rng if isinstance(rng, FoldedSeed) else int(rng)


class _Draws:
    """The dropout draws of one seeded step: the fold path of each draw,
    in order, recorded at the warm-up (``mode`` "record"), and the
    persistent generators the capture (``mode`` "capture") draws from."""

    def __init__(self):
        self.paths, self.generators = [], []
        self.mode, self.taken = None, 0

    def generator(self, seed):
        """The generator of the draw at ``seed``'s path."""
        if self.mode == "record":
            self.paths.append(seed.path)
            return None
        k, self.taken = self.taken, self.taken + 1
        if k >= len(self.paths) or self.paths[k] != seed.path:
            raise RuntimeError(f"dropout draw {k} (path {seed.path}) differs from the "
                               "warm-up's draws")
        return self.generators[k]

    def bind(self, graph, device, base):
        """Persistent generators for the recorded draws, registered with
        ``graph`` before its capture begins."""
        self.generators = [torch.Generator(device=device) for _ in self.paths]
        for g in self.generators:
            graph.register_generator_state(g)
        self.reseed(base)

    def reseed(self, base):
        for g, path in zip(self.generators, self.paths):
            g.manual_seed(FoldedSeed(base, path).value())

    @contextlib.contextmanager
    def active(self, mode):
        self.mode, self.taken = mode, 0
        if mode == "record":
            self.paths = []
        try:
            yield self
        finally:
            self.mode = None


def dropout_uniform(shape, seed, device):
    """Uniforms in [0, 1) of ``shape`` for a dropout mask: from a
    generator seeded with ``seed`` (an int or a :class:`FoldedSeed`'s
    value), or, inside a seeded step's capture, from the draw's
    persistent generator (the module docstring)."""
    g = None
    if isinstance(seed, FoldedSeed) and seed.draws is not None and seed.draws.mode:
        g = seed.draws.generator(seed)
    if g is None:
        g = torch.Generator(device=device)
        g.manual_seed(seed.value() if isinstance(seed, FoldedSeed) else int(seed))
    return torch.rand(shape, generator=g, device=device)


# -------------------------------------------------- what capture refuses
class HostTraffic(RuntimeError):
    """A captured body read a device value on the host or copied between
    the host and the card: the graph would freeze the value read."""


class _NoHostTraffic(TorchDispatchMode):
    def __init__(self, device):
        super().__init__()
        self.device = device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            if args[0].device == self.device:
                raise HostTraffic(f"host read ({func}) of a value on {self.device}")
        elif func is torch.ops.aten._to_copy.default:
            dst = kwargs.get("device")
            if dst is not None and _crosses(args[0].device, torch.device(dst)):
                raise HostTraffic(f"copy {args[0].device} -> {dst} ({func})")
        elif func is torch.ops.aten.copy_.default:
            if _crosses(args[1].device, args[0].device):
                raise HostTraffic(f"copy {args[1].device} -> {args[0].device} ({func})")
        return func(*args, **kwargs)


def _crosses(a, b):
    return {a.type, b.type} == {"cpu", "cuda"}


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

    def fresh(self):
        """A new pool of the same kind, for captures after every graph of
        this one is freed (CUDA refuses a capture into a private pool whose
        last graph is gone)."""
        return GraphPool(self.device, None if self.handle is not None else self.graph_factory)


class StepGraph:
    """``body(**inputs)`` as one captured step (see the module docstring).

    ``inputs``: name -> a tensor whose shape and dtype each call's value
    of that name takes; the static buffers start as copies of them on
    ``device``, and warm-up and capture run on those values (the serving
    steps pass tables whose every entry is the scratch block, the
    training step a ``commit`` flag that is False).  ``pool``: a
    :class:`GraphPool`, or None to call the body directly.  ``body``
    returns a tensor or a tuple of tensors, which every call returns: the
    same tensors (the static outputs) each replay.  ``seeded``: each call
    takes ``step_seed=`` (an int), and the body ``seed=`` (its
    :class:`FoldedSeed`), its dropout draws captured as the module
    docstring describes.  ``hint`` ends the message of a failed capture."""

    def __init__(self, name: str, body: Callable, inputs: Dict[str, torch.Tensor],
                 device, pool: Optional[GraphPool] = None, seeded: bool = False,
                 hint: str = ""):
        self.name = name
        self.body = body
        self.device = torch.device(device)
        self.pool = pool
        self.hint = hint
        self.static = {k: v.to(self.device, copy=True) for k, v in inputs.items()}
        pin = pool is not None and self.device.type == "cuda"
        self._staging = ({k: torch.zeros_like(v, device="cpu").pin_memory()
                          for k, v in self.static.items()} if pin else None)
        self._copied = None              # event after the last host-to-device copies
        self._graph = None
        self._outputs = None
        self._delta = []                 # (counter dict, {kernel: launches}) per replay
        self._draws = _Draws() if seeded else None
        self._seed = None                # the step seed the static values go with
        self.captures = self.warmups = self.replays = 0
        self.pool_bytes = 0              # reserved device memory the capture added

    @property
    def captured(self) -> bool:
        return self._graph is not None

    @property
    def dropout_draws(self) -> int:
        """Dropout draws the captured step re-seeds before each replay."""
        return len(self._draws.generators) if self._draws is not None else 0

    def release(self):
        """Drop the graph, its static outputs and buffers (a step that is not
        called again); the counters stay."""
        self._graph = self._outputs = None
        self.static, self._staging, self._copied = {}, None, None

    def prepare(self):
        """Warm up and capture now, on the static buffers' values, if a
        pool was given and nothing is captured yet (a caller whose body
        advances state it must reset first, as ``generate``'s cache)."""
        if self.pool is not None and self._graph is None:
            self._capture()

    def _args(self):
        if self._draws is None:
            return self.static
        return dict(self.static, seed=FoldedSeed(self._seed, draws=self._draws))

    def __call__(self, step_seed=None, **values):
        if (step_seed is None) != (self._draws is None):
            raise ValueError(f"step {self.name}: step_seed is "
                             f"{'required' if self._draws is not None else 'not taken'}")
        if self.pool is None:
            self._fill(values)
            self._seed = step_seed
            return self.body(**self._args())
        if self._seed is None:
            self._seed = step_seed       # the warm-up and the capture's seed
        self.prepare()
        self._fill(values)
        if self._draws is not None:
            self._draws.reseed(step_seed)
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
            if self._staging is None or src.device == self.device:
                self.static[k].copy_(src.reshape(self.static[k].shape))
                continue
            self._staging[k].copy_(src.reshape(self._staging[k].shape))
            self.static[k].copy_(self._staging[k], non_blocking=True)
        if self._staging is not None:
            self._copied = torch.cuda.Event()
            self._copied.record()

    def _drawing(self, mode):
        return self._draws.active(mode) if self._draws is not None else contextlib.nullcontext()

    def _capture(self):
        pool = self.pool
        cuda = self.device.type == "cuda" and pool.stream is not None
        if cuda:
            pool.stream.wait_stream(torch.cuda.current_stream(self.device))
        counters = launch_counters()
        with torch.cuda.stream(pool.stream):
            with self._drawing("record"):         # the warm-up: real launches, counted
                self.body(**self._args())
            self.warmups += 1
            if cuda:
                torch.cuda.synchronize(self.device)
            before = _snapshot(counters)
            graph = pool.graph_factory()
            reserved = torch.cuda.memory_reserved(self.device) if cuda else 0
            # no garbage collection inside the capture: a collection there may free an
            # earlier engine's graph (a call the capture forbids, which invalidates it)
            gc_was_on = gc.isenabled()
            gc.disable()
            try:
                if self._draws is not None and self._draws.paths:
                    self._draws.bind(graph, self.device, self._seed)
                graph.capture_begin(pool=pool.handle)
                try:
                    with self._drawing("capture"), _NoHostTraffic(self.device):
                        outputs = self.body(**self._args())
                    if self._draws is not None and self._draws.taken != len(self._draws.paths):
                        raise RuntimeError(f"the capture drew {self._draws.taken} dropout "
                                           f"masks, the warm-up {len(self._draws.paths)}")
                finally:
                    graph.capture_end()
            except RuntimeError as e:
                raise RuntimeError(f"step {self.name}: CUDA graph capture failed: {e}"
                                   + (f" ({self.hint})" if self.hint else "")) from e
            finally:
                if gc_was_on:
                    gc.enable()
                after = _snapshot(counters)
                for counter, snap in zip(counters, before):
                    counter.update(snap)
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(pool.stream)
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self._delta = [(c, {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)})
                       for c, b, a in zip(counters, before, after)]
        self._graph, self._outputs = graph, outputs
        self.captures += 1
