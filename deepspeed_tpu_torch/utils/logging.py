"""Rank-filtered logging.

Counterpart of ``deepspeed_tpu/utils/logging.py`` (``logger`` +
``log_dist``).  Differences: the rank is ``torch.distributed``'s rank
when a process group is initialised (0 otherwise) instead of
``jax.process_index()``; the level comes from ``DSTPU_LOG_LEVEL`` as in
the JAX package.
"""

import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name, level):
    formatter = logging.Formatter(
        "[%(asctime)s] [%(levelname)s] "
        "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s")
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(level)
        ch.setFormatter(formatter)
        logger_.addHandler(ch)
    return logger_


logger = _create_logger(
    "deepspeed_tpu_torch",
    LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(),
                   logging.INFO))


def _rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the listed ranks (``None``/[-1] = all)."""
    my_rank = _rank()
    if ranks is None or len(ranks) == 0 or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
