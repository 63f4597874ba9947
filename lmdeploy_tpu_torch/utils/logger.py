"""Leveled logger (reference: src/turbomind/utils/logger.cc — TM_LOG_LEVEL
env, TM_LOG_FIRST_RANK_ONLY).  Env vars: LMDEPLOY_TPU_LOG_LEVEL
(TRACE|DEBUG|INFO|WARNING|ERROR) and LMDEPLOY_TPU_LOG_FIRST_RANK_ONLY=1
(only errors on every rank but 0 of a multi-rank run).

Copy of ``lmdeploy_tpu/utils/logger.py``.  The rank is
``torch.distributed``'s when its default group is initialised, else the
``RANK`` environment variable (0 without it), where the JAX package reads
``jax.process_index()``."""
from __future__ import annotations

import logging
import os

TRACE = 5
logging.addLevelName(TRACE, 'TRACE')

_LEVELS = {'TRACE': TRACE, 'DEBUG': logging.DEBUG, 'INFO': logging.INFO,
           'WARNING': logging.WARNING, 'ERROR': logging.ERROR}


def _rank() -> int:
    """This process's global rank."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get('RANK', '0'))


def get_logger(name: str = 'lmdeploy_tpu_torch') -> logging.Logger:
    logger = logging.getLogger(name)
    if getattr(logger, '_lmdeploy_tpu_init', False):
        return logger
    logger._lmdeploy_tpu_init = True
    level = _LEVELS.get(os.environ.get('LMDEPLOY_TPU_LOG_LEVEL',
                                       'WARNING').upper(), logging.WARNING)
    logger.setLevel(level)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            '[lmdeploy-tpu-torch][%(levelname)s] %(asctime)s %(message)s',
            datefmt='%H:%M:%S'))
        logger.addHandler(h)
    if os.environ.get('LMDEPLOY_TPU_LOG_FIRST_RANK_ONLY', '0') == '1' \
            and _rank() != 0:
        logger.setLevel(logging.ERROR)
    return logger


__all__ = ['get_logger', 'TRACE']
