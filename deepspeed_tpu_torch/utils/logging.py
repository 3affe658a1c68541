"""Rank-aware logging (counterpart of ``deepspeed_tpu/utils/logging.py``).

The port runs one process per card; the rank is the process group's
(``comm.init_distributed``) when one is initialised, and 0 otherwise, so
``log_dist(..., ranks=[0])`` logs once per job.
"""

import functools
import logging
import os
import sys

LOG_LEVEL = os.environ.get("DEEPSPEED_TPU_LOG_LEVEL", "INFO").upper()

_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


@functools.lru_cache(None)
def _create_logger(name: str, level: str) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    return logger


logger = _create_logger("deepspeed_tpu_torch", LOG_LEVEL)


def _process_index() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def should_log_on_rank(ranks=None) -> bool:
    """True when this process should log: ``ranks=None`` means rank 0 only,
    a list containing -1 means every rank."""
    if ranks is None:
        ranks = [0]
    return -1 in ranks or _process_index() in ranks


def log_dist(message: str, ranks=None, level=logging.INFO) -> None:
    if should_log_on_rank(ranks):
        logger.log(level, "[Rank %s] %s", _process_index(), message)


def warning_once(message: str) -> None:
    _warn_once_cached(message)


@functools.lru_cache(None)
def _warn_once_cached(message: str) -> None:
    logger.warning(message)
