"""Double-buffered async tensor writer.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/async_swapper.py``
(``AsyncTensorSwapper``): a tensor queued for swap-out is copied into an
aligned pool buffer and written asynchronously while the caller goes on;
``add_buffers`` / ``flush`` bracket a burst.  The pool grows on demand
and is made anew on a dtype change; an exhausted pool drains the
in-flight writes (``acquire_swap_buffer``).

Deliberate differences: CPU torch tensors in and aligned torch buffers
(``utils.aligned_empty``); a write moves the buffer's block-rounded view,
its tail past the tensor zeroed, so it opens with ``O_DIRECT``.
"""

import torch

from .utils import SwapBufferPool, acquire_swap_buffer, aligned_numel, swap_out_tensors
from ...utils.retry import RetryPolicy


class AsyncTensorSwapper:
    def __init__(self, aio_handle, buffer_count=2, buffer_numel=None, retry=None):
        self.aio_handle = aio_handle
        self.retry = retry or RetryPolicy()
        self.buffer_count = max(2, buffer_count)
        self._pool = None
        self._buffer_numel = buffer_numel
        self._pending = []          # buffers with writes in flight
        self.swapped_bytes = 0

    def _ensure_pool(self, numel, dtype):
        itemsize = torch.empty((), dtype=dtype).element_size()
        need = aligned_numel(numel, itemsize)
        if (self._pool is None or self._buffer_numel is None or need > self._buffer_numel
                or self._pool.buffers[0].data.dtype != dtype):
            self._flush_pending()
            self._buffer_numel = need
            self._pool = SwapBufferPool(self.buffer_count, need, dtype)

    def swap_out(self, tensor, path):
        """Queue one tensor for an async write; returns once it is staged
        (the write completes at :meth:`flush`)."""
        flat = torch.as_tensor(tensor).detach().reshape(-1).cpu()
        self._ensure_pool(flat.numel(), flat.dtype)
        buf = acquire_swap_buffer(self._pool, drain=self._flush_pending, retry=self.retry)
        try:
            io = buf.io_view(flat.numel())
            io[:flat.numel()].copy_(flat)
            io[flat.numel():].zero_()
            swap_out_tensors(self.aio_handle, [io], [path], retry=self.retry)
        except Exception:
            self._pool.release(buf)
            raise
        self._pending.append(buf)
        self.swapped_bytes += flat.numel() * flat.element_size()

    def add_buffers(self, tensors, paths):
        for t, p in zip(tensors, paths):
            self.swap_out(t, p)

    def _flush_pending(self):
        if self._pending:
            self.aio_handle.wait()
            for b in self._pending:
                self._pool.release(b)
            self._pending = []

    def flush(self):
        """Wait until every queued write is on storage."""
        self._flush_pending()

    def release_buffers(self):
        self._flush_pending()
        self._pool = None
        self._buffer_numel = None
