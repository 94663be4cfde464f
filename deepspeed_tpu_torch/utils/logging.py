"""Rank-aware logging: the port's own copy of ``deepspeed_tpu/utils/logging.py``.

Process identity comes from ``torch.distributed`` when it is initialized,
else from the ``RANK`` environment variable.
"""

import functools
import logging
import os
import sys

LOG_FORMAT = "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"


@functools.lru_cache(None)
def _make_logger(name: str = "deepspeed_tpu_torch", level=logging.INFO):
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(logging.Formatter(LOG_FORMAT))
    logger_.addHandler(handler)
    return logger_


logger = _make_logger()


def _process_index() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def log_dist(message: str, ranks=None, level=logging.INFO) -> None:
    """Log ``message`` only on the given ranks (None / [-1] = all)."""
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
