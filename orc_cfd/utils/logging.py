"""Logging + observability.

The reference uses a dual system: `log` macros with env-controlled
levels plus bare println progress lines, and an optional rolling-file
tracing layer (main.rs:28-48, SURVEY.md 5). Here:

- `get_logger()` — standard Python logger, level from ORC_LOG
  (debug/info/warning), optionally mirrored to a rotating file via
  ORC_LOG_FILE;
- progress reporting in the solvers routes through this logger at INFO.
"""

from __future__ import annotations

import logging
import logging.handlers
import os

_LOGGER = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is not None:
        return _LOGGER
    logger = logging.getLogger("orc_cfd")
    level = os.environ.get("ORC_LOG", "info").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(h)
        log_file = os.environ.get("ORC_LOG_FILE")
        if log_file:
            fh = logging.handlers.RotatingFileHandler(
                log_file, maxBytes=64 * 2**20, backupCount=10
            )
            fh.setFormatter(
                logging.Formatter("%(asctime)s %(levelname)s %(message)s")
            )
            logger.addHandler(fh)
    _LOGGER = logger
    return logger
