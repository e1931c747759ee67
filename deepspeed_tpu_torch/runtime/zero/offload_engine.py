"""ZeRO-Offload's host optimizer tier, on one card over PCIe.

Counterpart of ``deepspeed_tpu/runtime/zero/offload_engine.py`` (lines
39-320: ``HostOffloadOptimizer``, ``FlatWireHandle``).  The card computes
the gradients (unscaled, clipped, flattened into one buffer); this object
owns, on the host, the flat fp32 master and the Adam moments, split into
``sub_group_size`` groups, runs the repo's native fused step
(``ops/adam/cpu_adam.py`` over ``csrc/adam/ds_cpu_adam.cpp``) group by
group, and keeps the compute-dtype payload image that the engine uploads:
one host sweep a step, the transfers at the step boundary only.

Host buffers: ``master``, ``m`` and ``v`` (numpy fp32, first-touched at
build), the fp32 gradient buffer ``grad32`` the step reads and, on the
wire, the landing buffer ``landing`` of the wire dtype (bf16 under bf16,
as JAX moves 16-bit gradients; fp32 otherwise) and the ``payload`` image
of the compute dtype, both pinned on a card.  bf16 gradients are widened
into ``grad32`` by the native ``ds_bf16_to_fp32``; fp32 ones land in it
directly.  The fused step writes the bf16 / fp16 image in its own pass
(``out16``); an fp32 image is the master copied after the step.

Checkpoint layout: :meth:`master_tree` and :meth:`moments_tree` rebuild
the parameter tree (the in-device ``AdamState``'s ``exp_avg`` /
``exp_avg_sq`` paths), so offload and in-device checkpoints load into
each other, and into the JAX package's engines.

The NVMe tier (``offload_optimizer.device == "nvme"``, JAX :79-95,
:229-250, :268-273, :310-312): the moments live in the swap files of a
``PartitionedOptimizerSwapper``, or of a ``PipelinedOptimizerSwapper``
under ``pipeline_read`` / ``pipeline_write`` (``runtime/swap_tensor``),
zeroed at build; a step swaps each sub-group in, runs the native Adam on
the swap buffers and swaps it out, and the pipelined swapper reads group
g+1 while g steps and g-1 is written.  ``moments()``, ``load_state`` and
so checkpoints go through the files.  ``swap_times`` holds the last
step's split (the swap-in wait, the Adam, the swap-out submit and wait)
and ``swap_bytes`` its bytes read and written.  The master stays in
host memory, as in JAX.

The streamed parameter tier (JAX :40-220; ``runtime/zero/param_stream.py``)
builds this object over the layer-major stream tree with
``consume_params`` (each init leaf dropped from its tree as the master
absorbs it) and then calls :meth:`alloc_buffers` with ``flat_wire=False``
(no whole-model landing buffer: its gradients land layer by layer, and
its ``grad32`` is a plain host buffer); with ``payload_in_ram=False``
(the NVMe parameter tier) no 16-bit image is kept and the layer payloads
are made by :meth:`encode_range`.  :meth:`payload_flat` /
:meth:`payload_tree` read the image, :meth:`drop_payload` frees it.  The
sparse-gradient wire lands through :meth:`flatten_grads`: a leaf may
arrive as ``{"sparse_indices", "sparse_values"}`` and is scattered with
an add into its zeroed segment, as ``np.add.at`` does in JAX.

Deliberate differences: the d2h and h2d are the engine's and the
runner's (``runtime/zero/wire.py``), and :class:`FlatWireHandle` holds
the handle of a started d2h into :attr:`HostOffloadOptimizer.landing`.
"""

import time

import numpy as np
import torch

from ...ops.adam.cpu_adam import DeepSpeedCPUAdam, host_memcpy, widen_bf16
from ...utils.logging import log_dist
from ..utils import tree_leaves, tree_map
from . import wire

OUT_DTYPE = {torch.bfloat16: "bfloat16", torch.float16: "float16", torch.float32: None}


def _slots(tree):
    """(container, key) of each leaf of ``tree`` in :func:`tree_leaves`
    order (dict keys sorted)."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    else:
        items = enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            yield from _slots(v)
        else:
            yield tree, k


def _leaves_up_to(template, tree):
    """``tree``'s subtrees at the leaf positions of ``template`` (JAX's
    ``flatten_up_to``): a leaf of the template may be a dict in ``tree``."""
    if isinstance(template, dict):
        return [x for k in sorted(template) for x in _leaves_up_to(template[k], tree[k])]
    if isinstance(template, (tuple, list)):
        return [x for t, u in zip(template, tree) for x in _leaves_up_to(t, u)]
    return [tree]


def _fill(template, leaves):
    """``template``'s structure with leaves taken from the iterator
    ``leaves`` in :func:`tree_leaves` order (dict keys sorted)."""
    if isinstance(template, dict):
        out = {k: _fill(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (tuple, list)):
        items = [_fill(t, leaves) for t in template]
        return type(template)(*items) if hasattr(template, "_fields") else type(template)(items)
    return next(leaves)


class FlatWireHandle:
    """A started d2h of the flat gradient buffer into
    :attr:`HostOffloadOptimizer.landing` (``wire.d2h_flat_start``'s
    handle); under the sparse wire, into ``dense`` (the other leaves'
    buffer), with ``sparse`` ``{leaf position: (indices, values)}``, the
    pinned host buffers the row-sparse leaves land in."""

    def __init__(self, handle, dense=None, sparse=None):
        self.handle = handle
        self.dense = dense
        self.sparse = sparse


class HostOffloadOptimizer:
    """The host master, moments and payload image of ``params0`` (a tree
    of tensors or numpy arrays).  ``consume_params``: each leaf of
    ``params0`` is dropped from its tree (dicts and lists) once the master
    holds it, and the buffers wait for :meth:`alloc_buffers`;
    ``payload_in_ram``: keep the compute-dtype image."""

    MOMENTS = ("exp_avg", "exp_avg_sq")

    def __init__(self, params0, zero_config, *, optimizer_name, optimizer_params,
                 compute_dtype, device, aio_config=None, retry=None, consume_params=False,
                 payload_in_ram=True):
        p = dict(optimizer_params or {})
        p.pop("torch_adam", None)
        # FusedAdam's default (adam_w_mode=True): the same rule with and without offload
        adam_w_mode = p.pop("adam_w_mode", True)
        self.opt = DeepSpeedCPUAdam(adamw_mode=True if optimizer_name == "adamw"
                                    else adam_w_mode, **p)
        self.compute_dtype = compute_dtype
        self.out_dtype = OUT_DTYPE[compute_dtype]
        self.wire_dtype = torch.bfloat16 if compute_dtype == torch.bfloat16 else torch.float32
        self.device = torch.device(device)

        # ---- the flat layout of the master, in tree_leaves order
        self._template = tree_map(lambda _: None, params0)    # the structure alone
        leaves = tree_leaves(params0)
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        sizes = [int(np.prod(s or (1,))) for s in self.shapes]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.numel = int(self.offsets[-1])
        self.master = np.empty(self.numel, np.float32)
        slots = list(_slots(params0)) if consume_params else None
        for i, (off, n) in enumerate(zip(self.offsets, sizes)):
            leaf = leaves[i]
            if consume_params:        # the init tree shrinks as the master fills
                leaves[i] = None
                container, key = slots[i]
                container[key] = None
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().to("cpu", torch.float32).numpy()
            self.master[off:off + n] = np.asarray(leaf, np.float32).ravel()
            del leaf

        sg = int(zero_config.sub_group_size)
        bounds = list(range(0, self.numel, sg)) + [self.numel]
        self.sub_groups = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
        off = zero_config.offload_optimizer
        self.nvme = off is not None and off.device == "nvme"
        self.swap_times, self.swap_bytes = {}, (0, 0)
        if self.nvme:
            from ..swap_tensor.partitioned_optimizer_swapper import (
                PartitionedOptimizerSwapper, PipelinedOptimizerSwapper)
            cls = PipelinedOptimizerSwapper if off.pipeline else PartitionedOptimizerSwapper
            big = max(e - s for s, e in self.sub_groups)
            self.swapper = cls(off, aio_config, off.nvme_path, retry=retry, buffer_numel=big,
                               pin=off.pin_memory and self.device.type == "cuda")
            zeros = torch.zeros(big)
            for g, (s, e) in enumerate(self.sub_groups):
                self.swapper.swap_out_group(g, {n: zeros[:e - s] for n in self.MOMENTS})
            self.m = self.v = None
        else:
            self.swapper = None
            self.m, self.v = self.opt.init_buffers(self.numel)
            self.m.fill(0.0)           # first touch now, not inside the first step
            self.v.fill(0.0)

        self.grad32 = self.landing = self.payload = None
        self._payload_in_ram = payload_in_ram
        if not consume_params:
            self.alloc_buffers()

    def alloc_buffers(self, flat_wire=True):
        """The gradient buffer ``grad32`` and the payload image (when kept),
        first-touched now; with ``flat_wire`` the whole-model wire's
        pinned ``landing`` buffer too (bf16 under bf16; fp32 gradients
        land in a pinned ``grad32``).  Apart from :meth:`__init__` so the
        streamed tier can free its init tree first."""
        wire16 = self.wire_dtype != torch.float32
        if self.grad32 is None:
            self.grad32 = wire.pinned(self.numel, torch.float32,
                                      self.device if flat_wire and not wire16 else "cpu")
            self.grad32.zero_()
        if flat_wire and self.landing is None:
            self.landing = (wire.pinned(self.numel, self.wire_dtype, self.device) if wire16
                            else self.grad32)
            self.landing.zero_()
        if self._payload_in_ram and self.payload is None:
            self.payload = wire.pinned(self.numel, self.compute_dtype, self.device)
            self.refresh_payload()
        log_dist(f"host offload optimizer: {self.numel} params, {len(self.sub_groups)} "
                 f"sub-group(s), moments on {'nvme' if self.nvme else 'cpu'}"
                 + (f" ({type(self.swapper).__name__}, {self.swapper.slots} slot(s) under "
                    f"{self.swapper.swap_folder})" if self.nvme else "")
                 + f", wire {self.wire_dtype}, payload "
                 + (f"{self.compute_dtype}, pinned {self.payload.is_pinned()}"
                    if self.payload is not None else "not kept"), ranks=[0])

    # ------------------------------------------------------------- payload
    def refresh_payload(self):
        """Re-encode the whole payload image from the master (build and
        load; a step updates it through the fused copy-back)."""
        if self.payload is not None:
            self.payload.copy_(torch.from_numpy(self.master))

    def encode_range(self, lo, hi, out):
        """``master[lo:hi]`` in the compute dtype, into the first ``hi - lo``
        elements of the tensor ``out`` (the NVMe parameter tier's layer
        payloads, made without a whole-model image)."""
        out[:hi - lo].copy_(torch.from_numpy(self.master[lo:hi]))

    def drop_payload(self):
        """Free the payload image (the NVMe parameter tier keeps it on disk)."""
        self.payload = None

    def payload_flat(self):
        """The payload image, one flat compute-dtype host tensor."""
        if self.payload is None:
            raise RuntimeError("the payload image was dropped (NVMe parameter tier); "
                               "use encode_range")
        return self.payload

    def payload_tree(self):
        """The payload image as the parameter tree (views of the image)."""
        src = self.payload_flat()
        return _fill(self._template, iter(
            src[off:off + int(np.prod(s or (1,)))].view(s)
            for off, s in zip(self.offsets, self.shapes)))

    @property
    def pinned_bytes(self):
        return sum(b.numel() * b.element_size() for b in {id(x): x for x in (
            self.grad32, self.landing, self.payload) if x is not None}.values()
            if b.is_pinned())

    # ---------------------------------------------------------- gradients
    def widen(self):
        """The landed gradients as fp32: ``grad32``, widened from the bf16
        landing buffer where the wire is bf16."""
        if self.landing is not self.grad32:
            widen_bf16(self.landing, self.grad32)
        return self.grad32

    def wire_tree(self, dense, sparse):
        """The gradient tree of a sparse-wire landing: each leaf position
        in ``sparse`` as ``{"sparse_indices", "sparse_values"}``, the others
        views of the flat ``dense`` in order."""
        items, o = [], 0
        for i, shape in enumerate(self.shapes):
            if i in sparse:
                items.append({"sparse_indices": sparse[i][0], "sparse_values": sparse[i][1]})
            else:
                n = int(np.prod(shape or (1,)))
                items.append(dense[o:o + n].view(shape))
                o += n
        return _fill(self._template, iter(items))

    def flatten_grads(self, grads):
        """A host gradient tree (tensors or arrays of any float dtype) into
        ``grad32``, widened; a leaf given as ``{"sparse_indices",
        "sparse_values"}`` (the sparse wire) is scattered with an add into
        its zeroed segment.  Returns ``grad32``."""
        for leaf, off, shape in zip(_leaves_up_to(self._template, grads), self.offsets,
                                    self.shapes):
            n = int(np.prod(shape or (1,)))
            seg = self.grad32[off:off + n]
            if isinstance(leaf, dict) and "sparse_indices" in leaf:
                seg.zero_()
                seg.view(shape).index_add_(0, torch.as_tensor(leaf["sparse_indices"]).long(),
                                           torch.as_tensor(leaf["sparse_values"]).float())
            else:
                seg.copy_(torch.as_tensor(leaf).reshape(-1))
        return self.grad32

    # ---------------------------------------------------------------- step
    def step(self, flat_grads, step_no, lr):
        """One fused host Adam step over every sub-group, in place; the
        payload image follows (when kept)."""
        g = flat_grads.numpy() if isinstance(flat_grads, torch.Tensor) else flat_grads
        # no image kept (the NVMe parameter tier): no 16-bit copy-back
        out16 = self.payload if self.out_dtype is not None else None
        kind = self.out_dtype if out16 is not None else None

        def adam(s, e, m, v):
            self.opt.step_flat(self.master[s:e], g[s:e], m, v, step_no, lr=lr,
                               out16=None if out16 is None else out16[s:e], out_dtype=kind)
        if not self.nvme:
            for s, e in self.sub_groups:
                adam(s, e, self.m[s:e], self.v[s:e])
        else:
            self._step_nvme(adam)
        if self.out_dtype is None and self.payload is not None:
            host_memcpy(self.payload.data_ptr(), self.master.ctypes.data, self.master.nbytes)

    def _step_nvme(self, adam):
        """Each sub-group swapped in, stepped by ``adam(s, e, m, v)`` and
        swapped out (JAX :229-250); the pipelined swapper prefetches
        group g+1 before group g steps and writes asynchronously."""
        sw, names = self.swapper, self.MOMENTS
        pipelined = hasattr(sw, "prefetch_group")
        r0, w0 = sw.bytes_read, sw.bytes_written
        t = dict.fromkeys(("swap_in_wait_s", "adam_s", "swap_out_s", "swap_out_wait_s"), 0.0)
        clock = time.perf_counter
        if pipelined:
            sw.prefetch_group(0, names)
        for g, (s, e) in enumerate(self.sub_groups):
            t0 = clock()
            if pipelined:
                bufs = sw.get_group(g, names)
                if g + 1 < len(self.sub_groups):
                    sw.prefetch_group(g + 1, names)
            else:
                bufs = sw.swap_in_group(g, names)
            t1 = clock()
            adam(s, e, bufs["exp_avg"], bufs["exp_avg_sq"])
            t2 = clock()
            sw.swap_out_group(g, bufs, async_op=pipelined)
            t["swap_in_wait_s"] += t1 - t0
            t["adam_s"] += t2 - t1
            t["swap_out_s"] += clock() - t2
        t0 = clock()
        sw.wait()
        t["swap_out_wait_s"] = clock() - t0
        self.swap_times = t
        self.swap_bytes = (sw.bytes_read - r0, sw.bytes_written - w0)

    # --------------------------------------------------------- checkpoints
    def _unflatten(self, flat):
        it = iter(torch.from_numpy(flat[off:off + int(np.prod(s or (1,)))].reshape(s).copy())
                  for off, s in zip(self.offsets, self.shapes))
        return _fill(self._template, it)

    def _unflatten_like(self, flat):
        """The parameter tree as owned tensors cut from ``flat`` (a flat
        tensor of the layout, on any device)."""
        it = iter(flat[off:off + int(np.prod(s or (1,)))].view(s).clone()
                  for off, s in zip(self.offsets, self.shapes))
        return _fill(self._template, it)

    def copy_into(self, tree, flat):
        """Copy ``flat`` (the layout, on ``tree``'s device) into the leaves
        of ``tree`` in place."""
        for leaf, off in zip(tree_leaves(tree), self.offsets):
            leaf.copy_(flat[off:off + leaf.numel()].view(leaf.shape))

    def master_tree(self):
        return self._unflatten(self.master)

    def moments(self):
        """(exp_avg, exp_avg_sq), flat fp32 numpy arrays: the host buffers,
        or on NVMe copies gathered from the swap files."""
        if not self.nvme:
            return self.m, self.v
        self.swapper.wait()
        m, v = np.empty(self.numel, np.float32), np.empty(self.numel, np.float32)
        for g, (s, e) in enumerate(self.sub_groups):
            bufs = self.swapper.swap_in_group(g, self.MOMENTS)
            m[s:e] = bufs["exp_avg"].numpy()
            v[s:e] = bufs["exp_avg_sq"].numpy()
        return m, v

    def moments_tree(self):
        """The moments in the parameter tree's layout (the in-device
        ``AdamState``'s paths, so checkpoints cross)."""
        m, v = self.moments()
        return {"exp_avg": self._unflatten(m), "exp_avg_sq": self._unflatten(v)}

    def _to_flat(self, tree):
        leaves = tree_leaves(tree)
        if len(leaves) == 1 and np.ndim(leaves[0]) == 1 and np.size(leaves[0]) == self.numel:
            leaves = [leaves[0]]
        out = np.empty(self.numel, np.float32)
        o = 0
        for leaf in leaves:
            a = (leaf.detach().to("cpu", torch.float32).numpy()
                 if isinstance(leaf, torch.Tensor) else np.asarray(leaf, np.float32))
            out[o:o + a.size] = a.ravel()
            o += a.size
        if o != self.numel:
            raise ValueError(f"a tree of {o} elements for {self.numel} parameters")
        return out

    def load_state(self, master_tree=None, m=None, v=None):
        """Copy a master tree and / or moment trees (or flat buffers) in
        place; the payload image follows the master."""
        if master_tree is not None:
            np.copyto(self.master, self._to_flat(master_tree))
        if m is not None and v is not None:
            m, v = self._to_flat(m), self._to_flat(v)
            if self.nvme:
                self.swapper.wait()
                for g, (s, e) in enumerate(self.sub_groups):
                    self.swapper.swap_out_group(g, {"exp_avg": torch.from_numpy(m[s:e]),
                                                    "exp_avg_sq": torch.from_numpy(v[s:e])},
                                                async_op=False)
            else:
                np.copyto(self.m, m)
                np.copyto(self.v, v)
        self.refresh_payload()
