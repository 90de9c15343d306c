"""Per-module stream logger (own copy of the JAX package's
``utils/logger.py``). The level comes from ``RSDL_TPU_LOG_LEVEL``
(default INFO); handlers are installed once per logger name."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = ("%(asctime)s %(levelname)s %(name)s "
           "%(module)s.%(funcName)s:%(lineno)d -- %(message)s")


def setup_custom_logger(name: str) -> logging.Logger:
    """Return a configured logger for ``name`` (idempotent)."""
    logger = logging.getLogger(name)
    if getattr(logger, "_rsdl_configured", False):
        return logger
    level_name = os.environ.get("RSDL_TPU_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level_name, logging.INFO))
    handler = logging.StreamHandler(stream=sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    logger._rsdl_configured = True  # type: ignore[attr-defined]
    return logger
