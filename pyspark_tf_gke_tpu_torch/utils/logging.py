"""Per-component loggers (the port's copy of the JAX package's
``utils/logging.get_logger``): one stdout handler per logger, guarded
against duplicates, level from an explicit argument, else the
``PYSPARK_TF_GKE_TPU_LOG_LEVEL`` environment variable, else INFO."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional, Union

_FORMAT = "%(asctime)s %(levelname)s %(name)s: %(message)s"

# Loggers whose level was pinned by an explicit ``level=`` argument — a
# later default-level call must not silently reset them.
_explicit_levels: set = set()


def _env_level() -> Optional[int]:
    raw = os.environ.get("PYSPARK_TF_GKE_TPU_LOG_LEVEL", "").strip()
    if not raw:
        return None
    if raw.isdigit():
        return int(raw)
    level = logging.getLevelName(raw.upper())
    return level if isinstance(level, int) else None


def get_logger(name: str,
               level: Optional[Union[int, str]] = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if level is not None:
        if isinstance(level, str):
            resolved = logging.getLevelName(level.upper())
            if not isinstance(resolved, int):
                raise ValueError(f"unknown log level {level!r}")
            level = resolved
        logger.setLevel(level)
        _explicit_levels.add(name)
    elif name not in _explicit_levels:
        logger.setLevel(_env_level() or logging.INFO)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    return logger
