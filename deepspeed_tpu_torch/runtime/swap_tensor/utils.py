"""Swap-buffer plumbing shared by the NVMe swappers.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor/utils.py``:
``swappable_numel`` / ``aligned_numel`` (``MIN_AIO_BYTES``,
``AIO_ALIGNED_BYTES``), ``aio_submit_read`` / ``aio_submit_write`` under
``utils/retry.py`` with the ``aio.submit`` fault site, ``swap_in_tensors``
/ ``swap_out_tensors``, :class:`SwapBuffer`, :class:`SwapBufferPool`,
``acquire_swap_buffer``, ``make_swap_path`` and ``make_aio_handle``.

Deliberate differences: the buffers are CPU torch tensors, allocated
4096-byte aligned (:func:`aligned_empty`; pinned when the caller asks,
on a card) with sizes rounded to ``AIO_ALIGNED_BYTES`` = 4096 (JAX: 1024
and unaligned numpy arrays), so every request of the C library
(``csrc/aio/ds_aio.cpp:18-20``) opens with ``O_DIRECT`` and never goes
through the page cache on a filesystem that takes it, also on a disk of
4 KiB sectors.  :func:`aligned_read_bytes` reads a swap file written by
the JAX package (its exact size, not rounded) with the bytes it holds.
"""

import os

import torch

from ... import fault
from ...utils.retry import RetryPolicy, retry_call

MIN_AIO_BYTES = 1024 ** 2
AIO_ALIGNED_BYTES = 4096


def swappable_numel(numel, itemsize=4):
    """A tensor is worth swapping only from ``MIN_AIO_BYTES`` up."""
    return numel * itemsize >= MIN_AIO_BYTES


def aligned_numel(numel, itemsize=4):
    """``numel`` rounded up so its bytes are a multiple of
    ``AIO_ALIGNED_BYTES``."""
    align = AIO_ALIGNED_BYTES // itemsize
    return ((numel + align - 1) // align) * align


def aligned_empty(numel, dtype=torch.float32, pin=False):
    """A zeroed CPU tensor of ``aligned_numel(numel)`` elements whose first
    byte is ``AIO_ALIGNED_BYTES``-aligned (pinned when ``pin``)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = aligned_numel(numel, itemsize) * itemsize
    raw = torch.zeros(nbytes + AIO_ALIGNED_BYTES, dtype=torch.uint8, pin_memory=pin)
    off = (-raw.data_ptr()) % AIO_ALIGNED_BYTES
    return raw[off:off + nbytes].view(dtype)


def is_aligned(t):
    """Address and byte count both multiples of ``AIO_ALIGNED_BYTES``: the
    request opens with ``O_DIRECT``."""
    return (t.data_ptr() % AIO_ALIGNED_BYTES == 0
            and t.numel() * t.element_size() % AIO_ALIGNED_BYTES == 0)


def aligned_read_bytes(path, numel, itemsize=4):
    """The bytes to read for ``numel`` elements from ``path``: the aligned
    count where the file holds it (the port's swap files), else the exact
    one (a file the JAX package wrote)."""
    want = aligned_numel(numel, itemsize) * itemsize
    size = os.path.getsize(path)
    if size >= want:
        return want
    if size < numel * itemsize:
        raise OSError(f"swap file {path} holds {size} bytes, fewer than {numel} elements")
    return numel * itemsize


def aio_submit_read(aio_handle, buf, path, retry=None):
    """Submit one async read, retried with bounded backoff on a transient
    submit failure."""
    def _submit():
        fault.site("aio.submit", path=path)
        return aio_handle.async_pread(buf, path)
    return retry_call(_submit, policy=retry or RetryPolicy(), describe=f"aio read submit {path}")


def aio_submit_write(aio_handle, buf, path, retry=None):
    """Submit one async write, retried with bounded backoff."""
    def _submit():
        fault.site("aio.submit", path=path)
        return aio_handle.async_pwrite(buf, path)
    return retry_call(_submit, policy=retry or RetryPolicy(),
                      describe=f"aio write submit {path}")


def swap_in_tensors(aio_handle, buffers, paths, retry=None):
    """One async read per (buffer, path); the caller waits on the handle."""
    for buf, path in zip(buffers, paths):
        aio_submit_read(aio_handle, buf, path, retry=retry)


def swap_out_tensors(aio_handle, buffers, paths, retry=None):
    """One async write per (buffer, path)."""
    for buf, path in zip(buffers, paths):
        aio_submit_write(aio_handle, buf, path, retry=retry)


class SwapBuffer:
    """One reusable aligned host buffer with a free / busy flag."""

    def __init__(self, numel, dtype=torch.float32, pin=False):
        self.data = aligned_empty(numel, dtype, pin)
        self.in_use = False

    def view(self, numel):
        """The first ``numel`` elements."""
        return self.data[:numel]

    def io_view(self, numel):
        """The first ``aligned_numel(numel)`` elements: what a request moves."""
        return self.data[:aligned_numel(numel, self.data.element_size())]


class SwapBufferPool:
    """A fixed pool of swap buffers, handed out to in-flight swaps."""

    def __init__(self, count, numel, dtype=torch.float32, pin=False):
        self.buffers = [SwapBuffer(numel, dtype, pin) for _ in range(count)]

    def get(self):
        for b in self.buffers:
            if not b.in_use:
                b.in_use = True
                return b
        raise RuntimeError("no free swap buffer (increase buffer_count)")

    def release(self, buf):
        buf.in_use = False


def acquire_swap_buffer(pool, drain=None, retry=None):
    """A free buffer of ``pool``.  Each attempt first drains the pending
    writes (``drain``) so their buffers come back, and retries with
    bounded backoff; without ``drain`` nothing can free a buffer, so an
    exhausted pool fails at once."""
    def _get():
        try:
            return pool.get()
        except RuntimeError:
            if drain is None:
                raise
            drain()
            return pool.get()
    if drain is None:
        return _get()
    base = retry or RetryPolicy()
    policy = getattr(base, "_buffer_acquire_policy", None)
    if policy is None:
        policy = base.clone(retriable_types=(RuntimeError,) + base.retriable_types)
        base._buffer_acquire_policy = policy
    return retry_call(_get, policy=policy, describe="acquire_swap_buffer")


def make_swap_path(folder, name):
    os.makedirs(folder, exist_ok=True)
    return os.path.join(folder, f"{name}.swp")


def make_aio_handle(aio_config):
    """One :class:`~...ops.aio.AsyncIOHandle` from the ``aio`` config dict
    (JAX ``AIO_DEFAULT_DICT``'s defaults)."""
    from ...ops.aio import AsyncIOHandle
    aio = dict(aio_config or {})
    return AsyncIOHandle(block_size=aio.get("block_size", 1048576),
                         queue_depth=aio.get("queue_depth", 8),
                         single_submit=aio.get("single_submit", False),
                         overlap_events=aio.get("overlap_events", True),
                         thread_count=aio.get("thread_count", 1))
