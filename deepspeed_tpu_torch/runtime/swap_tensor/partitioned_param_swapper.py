"""NVMe parameter swapper (the ZeRO-Infinity parameter tier).

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/partitioned_param_swapper.py``
(``AsyncPartitionedParameterSwapper``): parameter payloads live in one
file per id under ``<nvme_path>/zero_stage_3/<dtype>params/rank<r>/``
(JAX's layout; ``float32params`` for fp32), and a bounded pool of
aligned host buffers serves swap-in (async reads ahead of use) and
swap-out (async writes after release).  Its engine user is the streamed
parameter runner's NVMe tier (``runtime/zero/param_stream.py``).
``bytes_read`` / ``bytes_written`` count the bytes its requests move.

Deliberate differences: CPU torch tensors and aligned torch buffers
(``utils.aligned_empty``); each request moves the buffer's block-rounded
view (tail zeroed), so it opens with ``O_DIRECT``.
"""

import os

import torch

from .utils import (SwapBufferPool, acquire_swap_buffer, aligned_numel, make_swap_path,
                    swap_in_tensors, swap_out_tensors)
from ...utils.retry import RetryPolicy

DTYPE_NAMES = {torch.float32: "float32", torch.float16: "float16", torch.bfloat16: "bfloat16"}


class AsyncPartitionedParameterSwapper:
    def __init__(self, ds_config_aio, nvme_path, dtype=torch.float32, buffer_count=5,
                 buffer_numel=int(1e8), rank=0, retry=None):
        from .utils import make_aio_handle
        self.aio_read_handle = make_aio_handle(ds_config_aio)
        self.aio_write_handle = make_aio_handle(ds_config_aio)
        self.retry = retry or RetryPolicy()
        self.dtype = dtype
        self.swap_folder = os.path.join(nvme_path, "zero_stage_3",
                                        f"{DTYPE_NAMES[dtype]}params", f"rank{rank}")
        os.makedirs(self.swap_folder, exist_ok=True)
        itemsize = torch.empty((), dtype=dtype).element_size()
        self.buffer_numel = aligned_numel(buffer_numel, itemsize)
        self._pool = SwapBufferPool(buffer_count, self.buffer_numel, dtype)
        self._id_to_numel = {}       # swapped param id -> numel
        self._id_to_buffer = {}      # swapped-in id -> SwapBuffer
        self._inflight_reads = []    # ids with reads in flight
        self._inflight_writes = []   # buffers with writes in flight
        self.bytes_read = self.bytes_written = 0

    def _path(self, param_id):
        return make_swap_path(self.swap_folder, f"param_{param_id}")

    def swap_out(self, param_id, tensor):
        """Write one parameter payload to NVMe and release its buffer."""
        flat = torch.as_tensor(tensor).detach().reshape(-1).to("cpu", self.dtype)
        if flat.numel() > self.buffer_numel:
            raise ValueError(f"param {param_id} ({flat.numel()}) exceeds the buffer size "
                             f"{self.buffer_numel}")
        self._id_to_numel[param_id] = flat.numel()
        buf = acquire_swap_buffer(self._pool, drain=self.synchronize_writes, retry=self.retry)
        try:
            io = buf.io_view(flat.numel())
            io[:flat.numel()].copy_(flat)
            io[flat.numel():].zero_()
            swap_out_tensors(self.aio_write_handle, [io], [self._path(param_id)],
                             retry=self.retry)
            self.bytes_written += io.numel() * io.element_size()
        except Exception:
            self._pool.release(buf)      # not in flight yet: nothing else frees it
            raise
        self._inflight_writes.append(buf)
        old = self._id_to_buffer.pop(param_id, None)
        if old is not None:
            self._pool.release(old)

    def synchronize_writes(self):
        if self._inflight_writes:
            self.aio_write_handle.wait()
            for b in self._inflight_writes:
                self._pool.release(b)
            self._inflight_writes = []

    def swap_in(self, param_ids, async_op=False):
        """Start reads of ``param_ids`` into pool buffers (a prefetch when
        ``async_op``; otherwise block until they are resident)."""
        self.synchronize_writes()
        for pid in param_ids:
            if pid in self._id_to_buffer or pid in self._inflight_reads:
                continue
            buf = acquire_swap_buffer(self._pool, retry=self.retry)
            try:
                io = buf.io_view(self._id_to_numel[pid])
                swap_in_tensors(self.aio_read_handle, [io], [self._path(pid)], retry=self.retry)
                self.bytes_read += io.numel() * io.element_size()
            except Exception:
                self._pool.release(buf)
                raise
            self._id_to_buffer[pid] = buf
            self._inflight_reads.append(pid)
        if not async_op:
            self.synchronize_reads()

    def synchronize_reads(self):
        if self._inflight_reads:
            self.aio_read_handle.wait()
            self._inflight_reads = []

    def get_buffer(self, param_id):
        """The host tensor of a resident parameter."""
        if param_id not in self._id_to_buffer:
            raise KeyError(f"param {param_id} is not swapped in")
        if param_id in self._inflight_reads:
            raise RuntimeError(f"param {param_id}: its read is not synchronized")
        return self._id_to_buffer[param_id].view(self._id_to_numel[param_id])

    def release(self, param_ids):
        """Release host buffers (the payload stays on NVMe)."""
        for pid in param_ids:
            buf = self._id_to_buffer.pop(pid, None)
            if buf is not None:
                self._pool.release(buf)

    def available_swap_in_buffers(self):
        return sum(1 for b in self._pool.buffers if not b.in_use)
