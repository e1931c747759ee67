"""NVMe optimizer-state swapper.

Counterpart of
``deepspeed_tpu/runtime/swap_tensor/partitioned_optimizer_swapper.py``
(``OptimizerSwapper``, ``PartitionedOptimizerSwapper``,
``PipelinedOptimizerSwapper``): the Adam moments of each sub-group live
on NVMe between steps, in JAX's layout,
``<nvme_path>/zero_stage_optimizer/rank<r>/group<g>_<name>.swp``, so
either package reads the other's swap directory; a step swaps a group
in, updates it and swaps it out.  The pipelined swapper reads group g+1
while group g steps and group g-1 is written.

Buffers: ``slots`` pairs of aligned host buffers (``utils.SwapBuffer``)
of the largest group, each slot with its own AIO handle; group g always
uses slot ``g % slots``.  A slot's requests run in submission order
against its own handle, so a group's write and its next read are
ordered without a global drain: before a slot is reused its handle is
waited on, and with three slots that wait is on the write of group g-2,
which the step of g-1 has overlapped.  The synchronous swapper waits on
every request.  Each request moves the buffer's block-rounded view (the
tail past the group zeroed), so a file is ``aligned_numel`` elements
long and every request opens with ``O_DIRECT``; a JAX-written file (its
exact size) is read with the bytes it holds.

Deliberate differences: JAX allocates a numpy array per swap-in and
copies per swap-out; here the moments are read into and written from
the slots' buffers, so :meth:`get_group` / :meth:`swap_in_group` return
views that stay valid until the slot is reused (the next use of group
``g + slots``).  ``buffer_count`` sets the buffers, two a slot: at least
one slot, three when pipelined.
"""

import os

import torch

from .utils import (SwapBuffer, aio_submit_read, aio_submit_write, aligned_read_bytes,
                    make_aio_handle, make_swap_path)
from ...utils.retry import RetryPolicy


class OptimizerSwapper:
    """Per-(group, name) files over ``slots`` buffer slots; synchronous
    unless a call asks for ``async_op``."""

    MIN_SLOTS = 1

    def __init__(self, swap_config, aio_config, nvme_path, rank=0, retry=None,
                 buffer_numel=0, pin=False):
        self.retry = retry or RetryPolicy()
        self.swap_folder = os.path.join(nvme_path, "zero_stage_optimizer", f"rank{rank}")
        os.makedirs(self.swap_folder, exist_ok=True)
        count = int(getattr(swap_config, "buffer_count", 4) or 0)
        self.slots = max(self.MIN_SLOTS, count // 2)
        self._aio_config = aio_config
        self._handles = [make_aio_handle(aio_config) for _ in range(self.slots)]
        self._bufs = [{} for _ in range(self.slots)]     # slot -> name -> SwapBuffer
        self._busy = [False] * self.slots                 # requests submitted since a wait
        self.buffer_numel = int(buffer_numel)
        self._pin = pin
        self._numel = {}                                  # (group, name) -> numel
        self.bytes_read = self.bytes_written = 0

    def _path(self, group, name):
        return make_swap_path(self.swap_folder, f"group{group}_{name}")

    def set_numel(self, group, name, numel):
        """Declare a group's tensor of ``numel`` elements (a swap directory
        that another process wrote)."""
        self._numel[(group, name)] = int(numel)

    def _slot(self, group):
        return group % self.slots

    def _wait_slot(self, slot):
        if self._busy[slot]:
            self._busy[slot] = False
            self._handles[slot].wait()

    def _buffer(self, slot, name, numel):
        buf = self._bufs[slot].get(name)
        if buf is None or buf.data.numel() < numel:
            buf = self._bufs[slot][name] = SwapBuffer(max(numel, self.buffer_numel),
                                                      torch.float32, self._pin)
        return buf

    def _read(self, group, names):
        """Submit the reads of ``names`` of ``group`` into its slot (waited
        on first); returns the slot."""
        slot = self._slot(group)
        self._wait_slot(slot)
        for name in names:
            numel = self._numel[(group, name)]
            path = self._path(group, name)
            nbytes = aligned_read_bytes(path, numel)
            view = self._buffer(slot, name, numel).data[:nbytes // 4]
            aio_submit_read(self._handles[slot], view, path, retry=self.retry)
            self.bytes_read += nbytes
        self._busy[slot] = True
        return slot

    def _views(self, slot, group, names):
        return {n: self._bufs[slot][n].view(self._numel[(group, n)]) for n in names}

    def swap_out_group(self, group, tensors, async_op=False):
        """Write ``{name: flat fp32 tensor}`` of one group.  A tensor that
        is the group's own slot view (from :meth:`get_group` /
        :meth:`swap_in_group`) is written from where it is; any other is
        copied into the slot first."""
        slot = self._slot(group)
        own = all(n in self._bufs[slot] and t.data_ptr() == self._bufs[slot][n].data.data_ptr()
                  for n, t in tensors.items())
        if not own:
            self._wait_slot(slot)
        for name, t in tensors.items():
            t = torch.as_tensor(t).reshape(-1)
            numel = t.numel()
            self._numel[(group, name)] = numel
            buf = self._buffer(slot, name, numel)
            io = buf.io_view(numel)
            if not own:
                io[:numel].copy_(t)
            io[numel:].zero_()
            aio_submit_write(self._handles[slot], io, self._path(group, name), retry=self.retry)
            self.bytes_written += io.numel() * 4
        self._busy[slot] = True
        if not async_op:
            self._wait_slot(slot)

    def swap_in_group(self, group, names, async_op=False):
        """Read the named tensors of one group into its slot; returns
        ``{name: view}``, valid until the slot is reused."""
        slot = self._read(group, names)
        if not async_op:
            self._wait_slot(slot)
        return self._views(slot, group, names)

    def wait(self):
        """Wait on every slot."""
        for slot in range(self.slots):
            self._wait_slot(slot)


class PartitionedOptimizerSwapper(OptimizerSwapper):
    """Synchronous per-group swap."""


class PipelinedOptimizerSwapper(OptimizerSwapper):
    """The overlapped swapper: group g+1's read and group g-1's write run
    while group g steps (three slots at least)."""

    MIN_SLOTS = 3

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._prefetched = {}            # group -> slot with its reads in flight

    def prefetch_group(self, group, names):
        if group not in self._prefetched:
            self._prefetched[group] = self._read(group, names)

    def get_group(self, group, names):
        """The group's tensors: the prefetch's, waited on, else a
        synchronous read."""
        slot = self._prefetched.pop(group, None)
        if slot is None:
            return self.swap_in_group(group, names)
        self._wait_slot(slot)
        return self._views(slot, group, names)

    def swap_out_group(self, group, tensors, async_op=True):
        self._prefetched.pop(group, None)
        super().swap_out_group(group, tensors, async_op=async_op)

    def wait(self):
        self._prefetched.clear()
        super().wait()
