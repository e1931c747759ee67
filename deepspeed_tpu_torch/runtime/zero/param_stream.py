"""ZeRO-3 parameter offload: the parameters live on the host (or NVMe) and
the layer blocks stream through the card during the forward and backward.

Counterpart of ``deepspeed_tpu/runtime/zero/param_stream.py`` (lines
54-765: ``to_stream_tree``, ``from_stream_tree``, ``ParamStreamRunner``).
The model exposes its forward in per-layer pieces (``model.stream_fns()``:
embed, block, head) and a Python loop runs one block a layer:

- the host optimizer (``offload_engine.HostOffloadOptimizer``) is built
  over the layer-major stream tree ``{"layers": [L layer dicts],
  "nonblock": {...}}``, so its flat buffers read ``[layer 0 | ... | layer
  L-1 | nonblock]`` and each layer is one contiguous segment (checked at
  build, as JAX checks it, :119-147);
- forward: layer l+1's payload segment is uploaded while layer l's block
  computes (``wire.LayerWire``: two device layer buffers, the upload on a
  copy stream ordered by events); each block's input is kept;
- backward: the layers stream in again in reverse; each block's forward
  runs again under autograd and its gradient w.r.t. the layer's params
  and its input is taken; the layer's gradients leave as the wire dtype
  (bf16 under bf16, times ``1/gas``, as JAX's) and a worker thread
  accumulates them in fp32 into the host gradient buffer, layer by layer
  and micro-batch by micro-batch, while the next layer's backward runs;
- the small "nonblock" params (embeddings, final LN) stay on the card,
  their gradients accumulated there in fp32 and landed once a step;
- the host global norm, the clip, the skip-step (non-finite loss or norm;
  the loss-spike sentinel on the host ``HostEma``) and the native host
  Adam over the same flat buffers; then the nonblock params are uploaded
  again.  The parameters are never whole on the card.

With ``offload_param.device == "nvme"`` the 16-bit layer payloads live in
one file a layer (``AsyncPartitionedParameterSwapper``), with no RAM image;
reads prefetch one layer ahead (``prefetch_layer_nvme``, which gives way
when the swapper's pool is exhausted, as JAX's does), each layer read is
staged into pinned memory before its upload, and every layer is written
again after each applied step.

Deliberate differences: the per-layer programs are eager torch calls, not
jits (no compile cache); ``rng`` is the engine's integer seed, folded as
``GPT2.apply`` folds it; the wire is one copy a layer, not 64 MB chunks
(``wire.py``); ``last_times`` keeps JAX's split (``device_plus_wire_s``,
``grad_d2h_land_s``, ``host_adam_s``, ``step_wall_s``) where
``grad_d2h_land_s`` is the worker's land-and-add time, and adds the
calling thread's wait for it, the h2d / d2h bytes and device seconds and
``overlap``; ``overlap = False`` runs the same loop eager-sequentially
(each upload and d2h on the compute stream, waited for, each add in the
calling thread), the reference the overlapped loop is held to bit for
bit.  The layer-wire quantization (JAX :164-306, ``comms_compression``'s
``param_stream`` route) waits for ROADMAP item 13; the config refuses
``comms_compression``.
"""

import time

import numpy as np
import torch

from ...utils.logging import log_dist, logger
from ..step_graph import fold
from ..utils import tree_leaves, tree_map
from .offload_engine import _fill
from .wire import LayerWire


def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(list(leaves))
    return np.stack(leaves)


def to_stream_tree(params, stacked_key):
    """Model tree (stacked blocks) -> layer-major stream tree."""
    blocks = params[stacked_key]
    L = tree_leaves(blocks)[0].shape[0]
    layers = [tree_map(lambda a: a[i], blocks) for i in range(L)]
    nonblock = {k: v for k, v in params.items() if k != stacked_key}
    return {"layers": layers, "nonblock": nonblock}


def from_stream_tree(tree, stacked_key):
    """Layer-major stream tree -> model tree (stacked blocks), so streamed
    and monolithic runs load each other's checkpoints."""
    layers = tree["layers"]
    out = dict(tree["nonblock"])
    out[stacked_key] = tree_map(lambda *ls: _stack(ls), *layers)
    return out


class ParamStreamRunner:
    """The streamed train and eval steps of one engine: the engine keeps
    the config, schedules, counters and checkpoints; this object keeps the
    per-layer loop and the layout between the host optimizer's flat
    buffers and the layer blocks."""

    def __init__(self, model, host_opt, device, *, gas, grad_clip, zero_config,
                 aio_config=None, retry=None, skip_nonfinite=True, spike=None):
        self.host = host_opt
        self.device = torch.device(device)
        self.gas = int(gas)
        self.grad_clip = float(grad_clip or 0.0)
        self.skip_nonfinite = bool(skip_nonfinite)
        self._spike_ema, self._skip_on_spike = None, False
        if spike is not None:
            from ..health import HostEma
            window, zmax, skip_on_spike = spike
            self._spike_ema = HostEma(window, zmax)
            self._skip_on_spike = bool(skip_on_spike)
        sf = self.sf = model.stream_fns()
        self.L = int(sf["n_layer"])
        self.local_flags = np.asarray(sf["local_flags"], bool)

        # ---- the layout: [layer 0 | ... | layer L-1 | nonblock], checked by index
        template = host_opt._template
        idx = _fill(template, iter(range(len(host_opt.shapes))))
        layer_ids = tree_leaves(idx["layers"][0])
        self.layer_shapes = [host_opt.shapes[i] for i in layer_ids]
        self.per_layer = sum(int(np.prod(s or (1,))) for s in self.layer_shapes)
        self.layer_bounds = []
        for i in range(self.L):
            lo = int(host_opt.offsets[min(tree_leaves(idx["layers"][i]))])
            if lo != i * self.per_layer:
                raise ValueError(f"layer {i} starts at {lo}, not {i * self.per_layer}: the "
                                 "layer segments must tile the front of the flat buffer")
            self.layer_bounds.append((lo, lo + self.per_layer))
        nb_ids = tree_leaves(idx["nonblock"])
        if min(nb_ids, default=len(host_opt.shapes)) < self.L * len(layer_ids):
            raise ValueError("the nonblock leaves must follow the layer segments")
        self.nb_lo, self.nb_hi = self.L * self.per_layer, host_opt.numel
        self._layer_template = template["layers"][0]
        self._nb_template = template["nonblock"]
        self._nb_shapes = [host_opt.shapes[i] for i in nb_ids]
        self.dtype = host_opt.compute_dtype
        self.wire_dtype = host_opt.wire_dtype

        # ---- the NVMe parameter tier
        off_p = zero_config.offload_param
        self.nvme = off_p is not None and off_p.device == "nvme"
        self.swapper = None
        if self.nvme:
            from ..swap_tensor.partitioned_param_swapper import AsyncPartitionedParameterSwapper
            self.swapper = AsyncPartitionedParameterSwapper(
                aio_config, off_p.nvme_path, dtype=self.dtype,
                buffer_count=max(4, int(off_p.buffer_count)), buffer_numel=self.per_layer,
                retry=retry)
            self._flush_layers_to_nvme(range(self.L))
            host_opt.drop_payload()

        # ---- the wire and the card-resident nonblock params
        self.wire = LayerWire(self.per_layer, self.dtype, self.wire_dtype, self.device)
        self._nb_buf = torch.empty(self.nb_hi - self.nb_lo, dtype=self.dtype,
                                   device=self.device)
        self._nonblock_dev = self._views(self._nb_buf, self._nb_template, self._nb_shapes)
        self._upload_nonblock()
        self.last_times = {}
        self._nvme_wait = 0.0          # this step's host wait for the blocking layer reads
        log_dist(f"param stream: {self.L} layers of {self.per_layer} params, nonblock "
                 f"{self.nb_hi - self.nb_lo}, payload on "
                 f"{'nvme (' + self.swapper.swap_folder + ')' if self.nvme else 'cpu'}, "
                 f"wire {self.wire_dtype}", ranks=[0])

    @staticmethod
    def _views(flat, template, shapes):
        """``template``'s tree over views of the flat tensor ``flat``."""
        out, o = [], 0
        for s in shapes:
            n = int(np.prod(s or (1,)))
            out.append(flat[o:o + n].view(s))
            o += n
        return _fill(template, iter(out))

    # ------------------------------------------------------------ NVMe tier
    def _flush_layers_to_nvme(self, layer_ids):
        buf = torch.empty(self.per_layer, dtype=self.dtype)
        for i in layer_ids:
            lo, hi = self.layer_bounds[i]
            self.host.encode_range(lo, hi, buf)
            self.swapper.swap_out(i, buf)
        self.swapper.synchronize_writes()

    def prefetch_layer_nvme(self, i):
        """Begin the NVMe read of layer ``i`` (a no-op on the cpu tier).
        Gives way, and leaves the read to the blocking :meth:`fetch_layer`,
        only when the swapper's pool has no free buffer, including a pool
        drained between the check and the acquire; any other error
        raises here, in its own context."""
        if self.nvme and 0 <= i < self.L:
            if self.swapper.available_swap_in_buffers() < 1:
                return
            try:
                self.swapper.swap_in([i], async_op=True)
            except RuntimeError as e:
                if "no free swap buffer" not in str(e):
                    raise
                logger.debug(f"prefetch_layer_nvme({i}): swap buffer pool drained between "
                             "the check and the acquire; the blocking fetch reads it")

    # --------------------------------------------------------------- uploads
    def fetch_layer(self, i):
        """Start layer ``i``'s upload; returns its wire slot (the block
        that reads it waits for the upload's event)."""
        if self.nvme:
            t0 = time.perf_counter()
            self.swapper.swap_in([i])
            self._nvme_wait += time.perf_counter() - t0
            stage = self.wire.staging(self.wire.next_slot())
            stage.copy_(self.swapper.get_buffer(i))
            self.swapper.release([i])
            return self.wire.upload(stage)
        lo, hi = self.layer_bounds[i]
        return self.wire.upload(self.host.payload_flat()[lo:hi])

    def _layer(self, slot):
        return self._views(self.wire.take(slot), self._layer_template, self.layer_shapes)

    def _upload_nonblock(self):
        if self.nvme:
            seg = torch.empty(self.nb_hi - self.nb_lo, dtype=self.dtype)
            self.host.encode_range(self.nb_lo, self.nb_hi, seg)
        else:
            seg = self.host.payload_flat()[self.nb_lo:self.nb_hi]
        with torch.no_grad():
            self._nb_buf.copy_(seg, non_blocking=self.device.type == "cuda")

    def _batch(self, mb):
        to_dev = lambda a: torch.as_tensor(np.asarray(a)).to(self.device)  # noqa: E731
        tokens, labels = self.sf["split_batch"](tree_map(to_dev, mb))
        return tokens, labels

    # -------------------------------------------------------------- forward
    def _forward(self, tokens, seed, deterministic, keep_inputs):
        """The embedding and every block with no autograd, streaming the
        layers up; returns the last hidden states (and each block's input)."""
        sf = self.sf
        rngs = sf["layer_rngs"](seed)
        x = sf["embed"](self._nonblock_dev, tokens, seed, deterministic)
        xs = []
        self.prefetch_layer_nvme(0)
        slot = self.fetch_layer(0)
        for i in range(self.L):
            p = self._layer(slot)
            self.prefetch_layer_nvme(i + 1)
            if keep_inputs:
                xs.append(x)
            x = sf["block"](p, x, rngs[i], bool(self.local_flags[i]), deterministic)
            self.wire.release(slot)
            slot = self.fetch_layer(i + 1) if i + 1 < self.L else None
        return x, xs, rngs

    @staticmethod
    def _leaf_grads(tree):
        """The leaves of ``tree`` as fresh autograd leaves (same storage)."""
        return [t.detach().requires_grad_() for t in tree_leaves(tree)]

    # ------------------------------------------------------------- training
    def train_step(self, micro_batches, seed, *, lr, step_no):
        """One optimizer step over the ``gas`` host micro-batches.  Returns
        the metrics (host values as 0-d CPU tensors)."""
        sf, host, wire = self.sf, self.host, self.wire
        inv_gas = 1.0 / self.gas
        grad32 = host.grad32
        t0 = time.perf_counter()
        wire.reset_stats()
        self._nvme_wait = 0.0
        io0 = (self.swapper.bytes_read, self.swapper.bytes_written) if self.nvme else (0, 0)
        grad32.zero_()
        losses, nb_grads = [], None
        nb_template = self._nb_template
        td = time.perf_counter()
        for mi, mb in enumerate(micro_batches):
            mb_seed = fold(seed, mi)
            tokens, labels = self._batch(mb)

            # ---------- forward: stream the layers up
            with torch.no_grad():
                x, xs, rngs = self._forward(tokens, mb_seed, False, keep_inputs=True)

            # ---------- head: loss and gradients
            with torch.enable_grad():
                nb = self._leaf_grads(self._nonblock_dev)
                xin = x.detach().requires_grad_()
                loss = sf["head_loss"](_fill(nb_template, iter(nb)), xin, labels)
                *d_nb, dx = torch.autograd.grad(loss, [*nb, xin], allow_unused=True)
            losses.append(loss.detach())
            del x, xin, loss

            # ---------- backward: stream the layers down, gradients out
            self.prefetch_layer_nvme(self.L - 1)
            slot = self.fetch_layer(self.L - 1)
            for i in range(self.L - 1, -1, -1):
                p = self._layer(slot)
                self.prefetch_layer_nvme(i - 1)
                with torch.enable_grad():
                    leaves = self._leaf_grads(p)
                    xin = xs[i].detach().requires_grad_()
                    y = sf["block"](_fill(self._layer_template, iter(leaves)), xin, rngs[i],
                                    bool(self.local_flags[i]), False)
                    dx, *dp = torch.autograd.grad(y, [xin, *leaves], grad_outputs=dx)
                wire.release(slot)
                del y, xin, leaves, p
                xs[i] = None                       # the block's input is done with
                flat = (torch.cat([g.float().reshape(-1) for g in dp]) * inv_gas).to(
                    self.wire_dtype)
                del dp
                slot = self.fetch_layer(i - 1) if i > 0 else None
                wire.grad_out(flat, grad32, self.layer_bounds[i][0])
                del flat

            # ---------- nonblock gradients, accumulated on the card in fp32
            with torch.enable_grad():
                nb = self._leaf_grads(self._nonblock_dev)
                x0 = sf["embed"](_fill(nb_template, iter(nb)), tokens, mb_seed, False)
                d_e = torch.autograd.grad(x0, nb, grad_outputs=dx, allow_unused=True)
            d = [_f32(a, t) + _f32(b, t) for a, b, t in zip(d_nb, d_e, nb)]
            nb_grads = d if nb_grads is None else [a + b for a, b in zip(nb_grads, d)]
            del nb, x0, d_e, d_nb, dx, d
        t_dev = time.perf_counter() - td

        # the nonblock gradients: landed once, in landing-slot pieces
        t1 = time.perf_counter()
        flat = (torch.cat([g.reshape(-1) for g in nb_grads]) * inv_gas).to(self.wire_dtype)
        for a in range(0, flat.numel(), self.per_layer):
            wire.grad_out(flat[a:a + self.per_layer], grad32, self.nb_lo + a)
        del flat, nb_grads
        wire.drain()
        t_land = time.perf_counter() - t1

        # ---------- the host norm, clip, skip-step, host Adam, payload refresh
        t1 = time.perf_counter()
        loss = float(np.mean([float(v) for v in losses]))
        gnorm = self._host_global_norm(grad32)
        z, spiked = (self._spike_ema.update(loss) if self._spike_ema is not None
                     else (0.0, False))
        skip = ((self.skip_nonfinite and not (np.isfinite(gnorm) and np.isfinite(loss)))
                or (self._skip_on_spike and spiked))
        if skip:
            logger.warning(f"param-stream step {step_no}: unhealthy sentinels (loss={loss}, "
                           f"grad_norm={gnorm}, z={z:.2f}); host optimizer step SKIPPED — "
                           "params and optimizer state untouched")
            t_adam = time.perf_counter() - t1
        else:
            if self.grad_clip > 0 and gnorm > self.grad_clip:
                grad32.mul_(self.grad_clip / (gnorm + 1e-6))
            host.step(grad32, step_no, lr)
            t_adam = time.perf_counter() - t1
            if self.nvme:
                t2 = time.perf_counter()
                self._flush_layers_to_nvme(range(self.L))
                t_flush = time.perf_counter() - t2
                t_adam += t_flush
            self._upload_nonblock()
        st = wire.stats
        self.last_times = {
            "device_plus_wire_s": t_dev, "grad_d2h_land_s": st["land_s"],
            "host_adam_s": t_adam, "step_wall_s": time.perf_counter() - t0,
            "land_wait_s": st["land_wait_s"], "nonblock_land_s": t_land,
            "h2d_bytes": st["h2d_bytes"], "d2h_bytes": st["d2h_bytes"],
            "h2d_copies": st["h2d"], "d2h_copies": st["d2h"],
            "h2d_s": wire.device_seconds("h2d"), "d2h_s": wire.device_seconds("d2h"),
            "overlap": wire.overlap}
        if self.nvme:
            sw = self.swapper
            self.last_times.update(nvme_read_wait_s=self._nvme_wait,
                                   nvme_flush_s=0.0 if skip else t_flush,
                                   nvme_read_bytes=sw.bytes_read - io0[0],
                                   nvme_written_bytes=sw.bytes_written - io0[1])
        f = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt)  # noqa: E731
        metrics = {"loss": f(loss), "grad_norm": f(gnorm), "overflow": f(False, torch.bool),
                   "lr": lr, "loss_scale": f(1.0), "skip": f(skip, torch.bool)}
        if self._spike_ema is not None:
            # the monitor reads this EMA's z (no second accounting)
            metrics["health_z"] = f(z)
            metrics["loss_spike"] = f(spiked, torch.bool)
        return metrics

    @staticmethod
    def _host_global_norm(flat):
        """sqrt of the chunked fp32 dots of ``flat``, summed in double."""
        total = 0.0
        step = 1 << 24
        for a in range(0, flat.numel(), step):
            seg = flat[a:a + step]
            total += float(torch.dot(seg, seg))
        return float(np.sqrt(total))

    # ------------------------------------------------------------- eval path
    def eval_loss(self, batch, seed):
        """The loss of one host micro-batch without dropout or gradients."""
        tokens, labels = self._batch(batch)
        with torch.no_grad():
            x, _, _ = self._forward(tokens, seed, True, keep_inputs=False)
            return self.sf["head_loss"](self._nonblock_dev, x, labels)

    # ---------------------------------------------------------- checkpoints
    def full_params_host(self):
        """The model tree (stacked blocks) in the compute dtype, on the host."""
        tree = self._host_tree_from_master() if self.nvme else self.host.payload_tree()
        return from_stream_tree(tree, self.sf["stacked_key"])

    def _host_tree_from_master(self):
        """The compute-dtype tree cast from the fp32 master (the NVMe tier
        keeps no image; the cast equals the payload written to its files)."""
        master = torch.from_numpy(self.host.master)
        return _fill(self.host._template, iter(
            master[o:o + int(np.prod(s or (1,)))].to(self.dtype).view(s)
            for o, s in zip(self.host.offsets, self.host.shapes)))

    def reload_from_host(self):
        """After the engine restores the host master: the NVMe layer files
        and the card's nonblock params again."""
        if self.nvme:
            self._flush_layers_to_nvme(range(self.L))
        self._upload_nonblock()

    def reset_health_ema(self):
        """At a checkpoint load: the restored run inherits no loss
        statistics of the steps it discarded."""
        if self._spike_ema is not None:
            self._spike_ema.reset()

    def close(self):
        """Drop the device buffers, the wire's thread and the swapper's pool."""
        self.wire.close()
        self._nonblock_dev = self._nb_buf = None
        swapper, self.swapper = self.swapper, None
        if swapper is not None:
            try:
                swapper.synchronize_writes()
                swapper.synchronize_reads()
            except (OSError, RuntimeError) as e:
                logger.warning(f"param-stream close: AIO drain failed ({e}); dropping the "
                               "buffers anyway")
            swapper.release(list(swapper._id_to_buffer))


def _f32(g, like):
    """``g`` in fp32, zeros of ``like``'s shape where autograd gave none."""
    if g is None:
        return torch.zeros(like.shape, dtype=torch.float32, device=like.device)
    return g.float()
