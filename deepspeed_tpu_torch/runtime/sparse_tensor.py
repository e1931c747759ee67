"""Row-sparse (indices, values) tensors for embedding-style gradients.

Counterpart of ``deepspeed_tpu/runtime/sparse_tensor.py`` (lines 1-68:
``SparseTensor``, ``sparse_allreduce``).  The engine's sparse-gradient
offload wire (``runtime/engine.py``, ``sparse_gradients``) sends a
declared lookup table's gradient as the rows a batch touched, and the
host scatters them back (``HostOffloadOptimizer.flatten_grads``).

:meth:`SparseTensor.from_dense` keeps JAX's integer keys and top-k: each
nonzero row outranks each zero row and an earlier row a later one, so
``torch.topk`` returns the first ``k`` nonzero rows, deterministically,
with a static ``k`` and no host read (it runs inside a captured step,
where ``torch.nonzero`` would sync).

Deliberate difference: :func:`sparse_allreduce` averages over one rank
(itself) and raises ``NotImplementedError`` across ranks, where JAX
all-gathers indices and values over a mesh axis (ROADMAP item 9).
"""

import numpy as np
import torch


class SparseTensor:
    """Row-sparse view of a 2-D tensor: ``values[i]`` is row ``indices[i]``."""

    def __init__(self, indices, values, dense_size):
        self.indices = torch.as_tensor(indices).to(torch.int32)
        self.values = torch.as_tensor(values)
        self.dense_size = tuple(dense_size)

    @classmethod
    def from_dense(cls, dense, max_rows=None, nz=None):
        """The first ``max_rows`` (default: all) nonzero rows of ``dense``,
        padded with zero rows; ``nz``: a precomputed per-row nonzero mask."""
        if nz is None:
            nz = (dense != 0).reshape(dense.shape[0], -1).any(dim=1)
        rows = dense.shape[0]
        k = max_rows if max_rows is not None else rows
        keys = (nz.to(torch.int32) * rows
                + torch.arange(rows, 0, -1, dtype=torch.int32, device=dense.device))
        idx = torch.sort(torch.topk(keys, k).indices).values
        vals = dense[idx] * nz[idx].to(dense.dtype).reshape(-1, *([1] * (dense.dim() - 1)))
        return cls(idx, vals, dense.shape)

    def to_dense(self):
        out = torch.zeros(self.dense_size, dtype=self.values.dtype, device=self.values.device)
        return out.index_add_(0, self.indices.long(), self.values)

    def add(self, other):
        if self.dense_size != other.dense_size:
            raise ValueError(f"dense sizes {self.dense_size} and {other.dense_size} differ")
        return SparseTensor(torch.cat([self.indices, other.indices]),
                            torch.cat([self.values, other.values]), self.dense_size)

    def sparse_size(self):
        return int(self.indices.shape[0]) * int(np.prod(self.values.shape[1:]))

    def __str__(self):
        return (f"SparseTensor(indices={tuple(self.indices.shape)}, "
                f"values={tuple(self.values.shape)}, dense_size={self.dense_size})")


def sparse_allreduce(st, group=None):
    """The average of a row-sparse gradient over the ranks of ``group``
    without densifying it (JAX: all-gather of indices and values).  One
    rank: ``st`` itself; more raise (ZeRO across ranks, ROADMAP item 9)."""
    import torch.distributed as dist
    n = dist.get_world_size(group) if dist.is_available() and dist.is_initialized() else 1
    if n != 1:
        raise NotImplementedError(f"sparse_allreduce across {n} ranks is not ported "
                                  "(ROADMAP item 9: ZeRO across ranks)")
    return SparseTensor(st.indices, st.values, st.dense_size)
