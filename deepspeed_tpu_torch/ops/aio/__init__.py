"""The async-IO handle over the repo's ``csrc/aio/ds_aio.cpp``.

Counterpart of ``deepspeed_tpu/ops/aio/__init__.py``: ``aio_available``
and ``AsyncIOHandle(block_size, queue_depth, single_submit,
overlap_events, thread_count)`` with the ``get_*`` accessors,
``pending_count``, ``sync_pread`` / ``sync_pwrite``, ``async_pread`` /
``async_pwrite`` and ``wait``, over the C ABI that
``ops/op_builder/builder.py``'s :class:`AsyncIOBuilder` builds and types.
The library is built at the first handle, never at import.

Deliberate difference: the buffers are contiguous CPU torch tensors
(pinned where a card is present), passed by ``data_ptr()``, where JAX
passes numpy arrays; every in-flight buffer is kept alive until
:meth:`AsyncIOHandle.wait`, as JAX's ``_inflight`` does.  The C code opens
a request with ``O_DIRECT`` when its buffer address, byte count and
offset are 512-aligned (``ds_aio.cpp:18-20``), so the swappers allocate
4096-aligned buffers of block-rounded sizes (``runtime/swap_tensor``).
"""

import shutil

import torch

from ..op_builder.builder import AsyncIOBuilder

_builder = AsyncIOBuilder()


def aio_available():
    """g++ and ``csrc/aio/ds_aio.cpp`` are present (JAX's
    ``is_compatible``)."""
    return shutil.which("g++") is not None and all(s.is_file() for s in _builder.sources())


def _check(buffer):
    if not isinstance(buffer, torch.Tensor):
        raise TypeError(f"aio buffers are torch tensors, got {type(buffer).__name__}")
    if buffer.device.type != "cpu" or not buffer.is_contiguous():
        raise ValueError(f"aio buffers must be contiguous CPU tensors (got "
                         f"{buffer.device}, contiguous {buffer.is_contiguous()})")
    return buffer.data_ptr(), buffer.numel() * buffer.element_size()


class AsyncIOHandle:
    """One I/O queue of ``thread_count`` workers in the C library."""

    def __init__(self, block_size=1048576, queue_depth=8, single_submit=False,
                 overlap_events=False, thread_count=1):
        self._lib = _builder.load()
        self._h = self._lib.dsaio_create(int(block_size), int(queue_depth),
                                         int(bool(single_submit)), int(bool(overlap_events)),
                                         int(thread_count))
        self._inflight = []          # async buffers: the C workers write them until wait()

    def get_block_size(self):
        return self._lib.dsaio_block_size(self._h)

    def get_queue_depth(self):
        return self._lib.dsaio_queue_depth(self._h)

    def get_single_submit(self):
        return bool(self._lib.dsaio_single_submit(self._h))

    def get_overlap_events(self):
        return bool(self._lib.dsaio_overlap_events(self._h))

    def get_thread_count(self):
        return self._lib.dsaio_thread_count(self._h)

    def pending_count(self):
        return self._lib.dsaio_pending_count(self._h)

    def sync_pread(self, buffer, filename, offset=0):
        """Read ``buffer``'s bytes at ``offset`` of ``filename``; returns
        the bytes read."""
        ptr, nbytes = _check(buffer)
        n = self._lib.dsaio_sync_pread(self._h, str(filename).encode(), ptr, nbytes, offset)
        if n < 0:
            raise OSError(f"aio read failed: {filename}")
        return n

    def sync_pwrite(self, buffer, filename, offset=0):
        ptr, nbytes = _check(buffer)
        n = self._lib.dsaio_sync_pwrite(self._h, str(filename).encode(), ptr, nbytes, offset)
        if n < 0:
            raise OSError(f"aio write failed: {filename}")
        return n

    def async_pread(self, buffer, filename, offset=0):
        ptr, nbytes = _check(buffer)
        rc = self._lib.dsaio_async_pread(self._h, str(filename).encode(), ptr, nbytes, offset)
        if rc < 0:
            raise OSError(f"aio submit read failed: {filename}")
        self._inflight.append(buffer)
        return rc

    def async_pwrite(self, buffer, filename, offset=0):
        ptr, nbytes = _check(buffer)
        rc = self._lib.dsaio_async_pwrite(self._h, str(filename).encode(), ptr, nbytes, offset)
        if rc < 0:
            raise OSError(f"aio submit write failed: {filename}")
        self._inflight.append(buffer)
        return rc

    def wait(self):
        """Block until every submitted async request has completed; returns
        their count, and raises if any failed."""
        n = self._lib.dsaio_wait(self._h)
        self._inflight.clear()
        if n < 0:
            raise OSError("aio wait: one or more requests failed")
        return n

    def __del__(self):
        h, self._h = getattr(self, "_h", None), None
        if h:
            self._lib.dsaio_destroy(h)
