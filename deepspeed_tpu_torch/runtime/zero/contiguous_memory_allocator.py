"""Contiguous host-memory allocator with defragmentation.

Counterpart of ``deepspeed_tpu/runtime/zero/contiguous_memory_allocator.py``
(``ContiguousMemoryAllocator``): one flat pre-allocated buffer handing
out views of a requested size, with ``release_tensor`` and a compaction
pass (``defragment``) that moves the live tensors to the front, so a
request that fits the total free space never fails from fragmentation.
It manages a host arena (the NVMe tier's staging buffers have the
lifetime pattern it serves).

Deliberate difference: the arena is a flat CPU torch tensor and the
views are torch views; the compaction copies with ``copy_`` (a move to
the left never overlaps its source's unread part, as in JAX).
"""

import torch

from ...utils.logging import logger


class ContiguousMemoryAllocator:
    def __init__(self, size, dtype=torch.float32, name="host_arena"):
        self.buffer = torch.zeros(size, dtype=dtype)
        self.size = size
        self.name = name
        self.contiguous_sizes = {0: size}   # address -> numel of each free block
        self.tensor_addresses = {}          # tensor id -> address
        self.tensor_sizes = {}              # tensor id -> numel
        self.tensor_map = {}                # tensor id -> view
        self.total_free = size
        self._next_id = 0

    def allocate_tensor(self, numel):
        """``(id, view)`` of ``numel`` elements; defragments first when no
        free block fits but the free total does."""
        if numel > self.total_free:
            raise MemoryError(f"{self.name}: requested {numel} > free {self.total_free}")
        if self._largest_free() < numel:
            logger.info(f"{self.name}: defragmenting (free={self.total_free}, need={numel})")
            self.defragment()
        addr = self._find_block(numel)
        self._carve(addr, numel)
        tid = self._next_id
        self._next_id += 1
        view = self.buffer[addr:addr + numel]
        self.tensor_addresses[tid] = addr
        self.tensor_sizes[tid] = numel
        self.tensor_map[tid] = view
        self.total_free -= numel
        return tid, view

    def release_tensor(self, tid):
        addr = self.tensor_addresses.pop(tid)
        numel = self.tensor_sizes.pop(tid)
        self.tensor_map.pop(tid)
        self.total_free += numel
        self._free(addr, numel)

    def get_tensor(self, tid):
        return self.tensor_map[tid]

    def defragment(self):
        """Compact the live tensors to the front, contents kept; the views
        in ``tensor_map`` are refreshed."""
        cursor = 0
        for tid, addr in sorted(self.tensor_addresses.items(), key=lambda kv: kv[1]):
            numel = self.tensor_sizes[tid]
            if addr != cursor:
                # the destination lies left of the source: copy in chunks no
                # longer than the gap, so no chunk overlaps its unread source
                gap = addr - cursor
                for o in range(0, numel, gap):
                    n = min(gap, numel - o)
                    self.buffer[cursor + o:cursor + o + n].copy_(
                        self.buffer[addr + o:addr + o + n])
                self.tensor_addresses[tid] = cursor
                self.tensor_map[tid] = self.buffer[cursor:cursor + numel]
            cursor += numel
        self.contiguous_sizes = {cursor: self.size - cursor} if cursor < self.size else {}

    def _largest_free(self):
        return max(self.contiguous_sizes.values(), default=0)

    def _find_block(self, numel):
        for addr in sorted(self.contiguous_sizes):
            if self.contiguous_sizes[addr] >= numel:
                return addr
        return None

    def _carve(self, addr, numel):
        block = self.contiguous_sizes.pop(addr)
        if block > numel:
            self.contiguous_sizes[addr + numel] = block - numel

    def _free(self, addr, numel):
        self.contiguous_sizes[addr] = numel
        merged = {}
        for a in sorted(self.contiguous_sizes):
            n = self.contiguous_sizes[a]
            if merged:
                last = max(merged)
                if last + merged[last] == a:
                    merged[last] += n
                    continue
            merged[a] = n
        self.contiguous_sizes = merged

    def print_allocation(self, resolution=200):
        """An ASCII map of the arena (``x`` live, ``.`` free)."""
        cell = max(1, self.size // resolution)
        marks = ["."] * (self.size // cell + 1)
        for tid, addr in self.tensor_addresses.items():
            for i in range(addr // cell, (addr + self.tensor_sizes[tid]) // cell + 1):
                if i < len(marks):
                    marks[i] = "x"
        line = "".join(marks)
        logger.info(f"{self.name}: [{line}] free={self.total_free}/{self.size}")
        return line
