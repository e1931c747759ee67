"""Config-driven data loader, in numpy.

Counterpart of ``deepspeed_tpu/runtime/dataloader.py``
(``DeepSpeedDataLoader``, ``RepeatingLoader``): the same
``(seed, epoch)`` permutation, batch order and tail padding (lines
162-201), so the port sees the JAX engine's batches in the JAX engine's
order, and the same checkpointable sampler state (:45-50, :121-145):
``state_dict`` is ``{"seed", "epoch", "batch_index", "batch_size"}``
and ``load_state_dict`` resumes the exact stream at the next
``__iter__``, converting the position through rows when the batch size
changed.  Batches are host numpy trees; the engine moves them to its
device.  ``collate_fn`` (default: stack each field) batches the samples
of a dataset that is not columnar, as in JAX.

Accepted dataset forms: a tuple/list of numpy arrays with equal leading
dim (samples are tuples), a dict of arrays (samples are dicts), or
anything with ``__getitem__``/``__len__``.
"""

import numpy as np

from ..utils.logging import logger


class RepeatingLoader:
    """Wrap an iterable loader to restart (next epoch) on StopIteration."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            if hasattr(self.loader, "new_epoch"):
                self.loader.new_epoch()
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def state_dict(self):
        sd = getattr(self.loader, "state_dict", None)
        return sd() if callable(sd) else None

    def load_state_dict(self, state):
        lsd = getattr(self.loader, "load_state_dict", None)
        if callable(lsd) and state is not None:
            exact = lsd(state)
            # the restored position takes effect at the next __next__
            self.data_iter = iter(self.loader)
            return exact
        return None


def _default_collate(samples):
    """Stack a list of samples into a batch tree of numpy arrays."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([np.asarray(s[k]) for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return tuple(np.stack([np.asarray(s[i]) for s in samples])
                     for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples])


class DeepSpeedDataLoader:
    """Shuffling, batching loader yielding micro-batches."""

    def __init__(self, dataset, batch_size, *, shuffle=True, seed=0, drop_last=False,
                 collate_fn=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or _default_collate
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.batch_index = 0      # batches yielded so far this epoch
        self._resume_batch = 0    # one-shot __iter__ offset set by load_state_dict
        self.drop_last = drop_last
        self._columnar = None
        if isinstance(dataset, dict):
            lens = {len(v) for v in dataset.values()}
            if len(lens) != 1:
                raise ValueError(f"ragged dict dataset: {lens}")
            self._len = lens.pop()
            self._columnar = "dict"
        elif (isinstance(dataset, (tuple, list)) and len(dataset) > 0
              and all(isinstance(a, np.ndarray) for a in dataset)):
            lens = {len(a) for a in dataset}
            if len(lens) != 1:
                raise ValueError(f"ragged tuple dataset: {lens}")
            self._len = lens.pop()
            self._columnar = "tuple"
        else:
            self._len = len(dataset)
        if self._len < batch_size:
            logger.warning(f"dataset ({self._len}) smaller than the micro-batch "
                           f"({batch_size}); it will be cycled within one batch")

    def __len__(self):
        if self.drop_last:
            return self._len // self.batch_size
        return (self._len + self.batch_size - 1) // self.batch_size

    def new_epoch(self):
        self.epoch += 1
        self.batch_index = 0
        self._resume_batch = 0

    def state_dict(self):
        return {"seed": self.seed, "epoch": self.epoch, "batch_index": self.batch_index,
                "batch_size": self.batch_size}

    def load_state_dict(self, state):
        """Restore the sampler position.  Returns True when it is exact,
        False when a batch-size change landed between batch boundaries and
        the position was floored (up to one batch of rows then replays)."""
        self.seed = int(state.get("seed", self.seed))
        self.epoch = int(state.get("epoch", 0))
        idx = int(state.get("batch_index", 0))
        saved_bs = int(state.get("batch_size", self.batch_size))
        exact = True
        if saved_bs != self.batch_size:
            # the row stream depends on (seed, epoch) only: convert through rows
            rows = idx * saved_bs
            idx, rem = divmod(rows, self.batch_size)
            if rem:
                exact = False
                logger.warning(f"data-loader position ({rows} rows at saved batch_size "
                               f"{saved_bs}) does not land on a batch boundary at the "
                               f"new batch_size {self.batch_size}; resuming at batch "
                               f"{idx} — up to {rem} rows replay")
        self.batch_index = idx
        self._resume_batch = idx     # consumed by the next __iter__ only
        return exact

    def _order(self):
        idx = np.arange(self._len)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _take(self, indices):
        if self._columnar == "dict":
            return {k: np.asarray(v)[indices] for k, v in self.dataset.items()}
        if self._columnar == "tuple":
            return tuple(np.asarray(a)[indices] for a in self.dataset)
        return self.collate_fn([self.dataset[int(i)] for i in indices])

    def _batch_indices(self, order):
        n_full = self._len // self.batch_size
        for b in range(n_full):
            yield order[b * self.batch_size:(b + 1) * self.batch_size]
        rem = self._len - n_full * self.batch_size
        if rem and not self.drop_last:
            # pad the tail by cycling the epoch's order
            yield np.concatenate([order[n_full * self.batch_size:],
                                  np.resize(order, self.batch_size - rem)])
        elif self._len < self.batch_size and n_full == 0:
            # tiny dataset + drop_last: one cycled batch rather than none
            yield np.resize(order, self.batch_size)

    def __iter__(self):
        start, self._resume_batch = self._resume_batch, 0
        self.batch_index = start
        for i, idx in enumerate(self._batch_indices(self._order())):
            if i < start:
                continue
            self.batch_index = i + 1
            yield self._take(idx)
