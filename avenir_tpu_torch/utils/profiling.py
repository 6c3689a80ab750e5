"""Structured logging: the reference's ``debug.on`` switch.

``get_logger(name, debug_on)`` — DEBUG level when on, WARNING otherwise,
one stderr handler, structured ``key=value`` text — as
``avenir_tpu.utils.profiling.get_logger``, with its environment override
renamed ``AVENIR_TPU_TORCH_LOG_LEVEL``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional


def get_logger(name: str,
               debug_on: Optional[bool] = None) -> logging.Logger:
    """The reference's per-class ``debug.on`` switch as a logger factory.

    ``debug_on=None`` leaves an already-configured logger's level alone
    (first configuration defaults to WARNING). A process whose ROOT logger
    already has handlers gets no handler from here: records propagate to
    the root and are emitted once. ``AVENIR_TPU_TORCH_LOG_LEVEL``
    (DEBUG/INFO/WARNING/ERROR), when set to a valid level name, pins the
    level and wins over ``debug_on``.
    """
    logger = logging.getLogger(f"avenir_tpu_torch.{name}")
    if not getattr(logger, "_avenir_configured", False):
        if logging.getLogger().handlers:
            logger.propagate = True
        else:
            handler = logging.StreamHandler()
            handler.setFormatter(logging.Formatter(
                "%(asctime)s level=%(levelname)s logger=%(name)s "
                "%(message)s"))
            logger.addHandler(handler)
            logger.propagate = False
        logger.setLevel(logging.WARNING)
        logger._avenir_configured = True  # type: ignore[attr-defined]
    env_level = getattr(
        logging,
        os.environ.get("AVENIR_TPU_TORCH_LOG_LEVEL", "").strip().upper(),
        None)
    if isinstance(env_level, int):
        logger.setLevel(env_level)
    elif debug_on is not None:
        logger.setLevel(logging.DEBUG if debug_on else logging.WARNING)
    return logger
