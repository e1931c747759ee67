"""Block-sparsity layout configurations.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py``
(17-312), a copy: the JAX module is pure numpy, but the port imports
nothing of the JAX package, so it keeps its own.  ``SparsityConfig`` and
the Dense, Fixed, Variable, BigBird and BSLongformer layouts, with the
same constructor parameters, the same random draws (``default_rng(0)``)
and so the same layouts bit for bit, and ``build_sparsity_config`` over
the JSON ``sparse_attention`` section.

A layout is an int array (num_heads_or_1, num_blocks, num_blocks): entry
[h, i, j] == 1 means query block i may attend key block j for head h.
The kernels consume it as a static block mask
(``ops/transformer/flash_attention.py:sparse_flash_attention``).  No
deliberate differences.
"""

import numpy as np


class SparsityConfig:
    """Base: block size + per-head layout plumbing."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head
        self.num_layout_heads = num_heads if different_layout_per_head else 1

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(f"Sequence length {seq_len} must be divisible by "
                             f"block size {self.block}")
        num_blocks = seq_len // self.block
        return np.zeros((self.num_layout_heads, num_blocks, num_blocks), np.int64)

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """All blocks allowed (dense baseline). Parity: reference :63."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        super().__init__(num_heads, block, different_layout_per_head)

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return layout


class FixedSparsityConfig(SparsityConfig):
    """Fixed local+global pattern. Parity: reference :94.

    Local: each query block attends its window of ``num_local_blocks``.
    Global: the last ``num_global_blocks`` of each window attend (and are
    attended by, if bidirectional/horizontal) everything.
    """

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False,
                 num_different_global_patterns=1):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        if num_local_blocks % num_global_blocks != 0:
            raise ValueError(
                f"num_local_blocks {num_local_blocks} must be divisible by "
                f"num_global_blocks {num_global_blocks}")
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only unidirectional or bidirectional attention is supported")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention requires bidirectional")
        self.horizontal_global_attention = horizontal_global_attention
        if num_different_global_patterns > 1 and not different_layout_per_head:
            raise ValueError("different global patterns require "
                             "different_layout_per_head")
        if num_different_global_patterns > num_local_blocks // num_global_blocks:
            raise ValueError(
                f"num_different_global_patterns {num_different_global_patterns} "
                f"exceeds num_local_blocks/num_global_blocks")
        self.num_different_global_patterns = num_different_global_patterns

    def _local(self, layout, h):
        num_blocks = layout.shape[1]
        for start in range(0, num_blocks, self.num_local_blocks):
            end = min(start + self.num_local_blocks, num_blocks)
            for i in range(start, end):
                hi = end if self.attention == "bidirectional" else i + 1
                layout[h, i, start:hi] = 1
        return layout

    def _global(self, layout, h):
        num_blocks = layout.shape[1]
        first_global = (h % self.num_different_global_patterns) * \
            self.num_global_blocks
        # which block columns act as global: last num_global_blocks of each
        # local window, offset by the per-head pattern index
        for start in range(0, num_blocks, self.num_local_blocks):
            gstart = start + self.num_local_blocks - \
                (first_global + self.num_global_blocks)
            gend = gstart + self.num_global_blocks
            gstart = max(gstart, 0)
            gend = min(gend, num_blocks)
            if gstart >= gend:
                continue
            # vertical: every query block attends the global columns (respect
            # causality for unidirectional)
            for i in range(num_blocks):
                for j in range(gstart, gend):
                    if self.attention == "bidirectional" or j <= i:
                        layout[h, i, j] = 1
            # horizontal: global rows attend everything
            if self.horizontal_global_attention:
                layout[h, gstart:gend, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        for h in range(self.num_layout_heads):
            layout = self._local(layout, h)
            layout = self._global(layout, h)
        return self.check_and_propagate_first_head_layout(layout)


class VariableSparsityConfig(SparsityConfig):
    """Variable windows + explicit/random global blocks. Parity: reference :243."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=0, local_window_blocks=None,
                 global_block_indices=None, global_block_end_indices=None,
                 attention="bidirectional", horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.local_window_blocks = local_window_blocks or [4]
        self.global_block_indices = global_block_indices or [0]
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("global_block_indices and "
                                 "global_block_end_indices must align")
            for s, e in zip(self.global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError("global block end must exceed start")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only unidirectional or bidirectional attention is supported")
        self.attention = attention
        if attention != "bidirectional" and horizontal_global_attention:
            raise ValueError("horizontal global attention requires bidirectional")
        self.horizontal_global_attention = horizontal_global_attention

    def _random(self, layout, h, rng):
        num_blocks = layout.shape[1]
        if self.num_random_blocks == 0:
            return layout
        for i in range(num_blocks):
            cols = rng.choice(num_blocks, self.num_random_blocks, replace=False)
            for j in cols:
                if self.attention == "bidirectional" or j <= i:
                    layout[h, i, j] = 1
        return layout

    def _local(self, layout, h):
        num_blocks = layout.shape[1]
        start = 0
        wi = 0
        while start < num_blocks:
            w = self.local_window_blocks[min(wi, len(self.local_window_blocks) - 1)]
            end = min(start + w, num_blocks)
            for i in range(start, end):
                hi = end if self.attention == "bidirectional" else i + 1
                layout[h, i, start:hi] = 1
            start = end
            wi += 1
        return layout

    def _global(self, layout, h):
        num_blocks = layout.shape[1]
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for (gs, ge) in spans:
            gs, ge = min(gs, num_blocks), min(ge, num_blocks)
            for i in range(num_blocks):
                for j in range(gs, ge):
                    if self.attention == "bidirectional" or j <= i:
                        layout[h, i, j] = 1
            if self.horizontal_global_attention:
                layout[h, gs:ge, :] = 1
        return layout

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        rng = np.random.default_rng(0)  # deterministic (layouts must be static)
        for h in range(self.num_layout_heads):
            layout = self._random(layout, h, rng)
            layout = self._local(layout, h)
            layout = self._global(layout, h)
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global. Parity: reference :421."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only unidirectional or bidirectional attention is supported")
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        if num_blocks < self.num_sliding_window_blocks:
            raise ValueError(f"seq has {num_blocks} blocks; sliding window "
                             f"needs {self.num_sliding_window_blocks}")
        rng = np.random.default_rng(0)
        w = self.num_sliding_window_blocks // 2
        for h in range(self.num_layout_heads):
            # sliding window
            for i in range(num_blocks):
                lo, hi = max(0, i - w), min(num_blocks, i + w + 1)
                layout[h, i, lo:hi] = 1
            # global (first blocks attend/are attended everywhere)
            g = self.num_global_blocks
            layout[h, :g, :] = 1
            layout[h, :, :g] = 1
            # random
            for i in range(num_blocks):
                cols = rng.choice(num_blocks, min(self.num_random_blocks,
                                                  num_blocks), replace=False)
                layout[h, i, cols] = 1
            if self.attention == "unidirectional":
                layout[h] = np.tril(layout[h])
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """Longformer: sliding window + indexed global blocks. Parity: reference :559."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=None,
                 global_block_end_indices=None, attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = global_block_indices or [0]
        if global_block_end_indices is not None:
            if len(self.global_block_indices) != len(global_block_end_indices):
                raise ValueError("global_block_indices and "
                                 "global_block_end_indices must align")
            for s, e in zip(self.global_block_indices, global_block_end_indices):
                if s >= e:
                    raise ValueError("global block end must exceed start")
        self.global_block_end_indices = global_block_end_indices
        if attention not in ("unidirectional", "bidirectional"):
            raise NotImplementedError(
                "only unidirectional or bidirectional attention is supported")
        self.attention = attention

    def make_layout(self, seq_len):
        layout = self.setup_layout(seq_len)
        num_blocks = layout.shape[1]
        w = self.num_sliding_window_blocks // 2
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for h in range(self.num_layout_heads):
            for i in range(num_blocks):
                lo, hi = max(0, i - w), min(num_blocks, i + w + 1)
                layout[h, i, lo:hi] = 1
            for (gs, ge) in spans:
                gs, ge = min(gs, num_blocks), min(ge, num_blocks)
                layout[h, gs:ge, :] = 1
                layout[h, :, gs:ge] = 1
            if self.attention == "unidirectional":
                layout[h] = np.tril(layout[h])
        return self.check_and_propagate_first_head_layout(layout)


MODE_TO_CONFIG = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "variable": VariableSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
}


def build_sparsity_config(sparse_attention_dict, num_heads):
    """From the JSON ``sparse_attention`` section (reference ``config.py:347-530``)."""
    d = dict(sparse_attention_dict)
    mode = d.pop("mode", "fixed")
    if mode not in MODE_TO_CONFIG:
        raise ValueError(f"Unknown sparse_attention mode {mode!r}; "
                         f"valid: {sorted(MODE_TO_CONFIG)}")
    return MODE_TO_CONFIG[mode](num_heads=num_heads, **d)
