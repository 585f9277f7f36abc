"""Leveled stderr logging, configured once per process (level from
YTPU_LOG_LEVEL), with a rate-limited variant; parity with the
reference's zero-dependency stderr logger
(yadcc/client/common/logging.{h,cc}) and its FLARE_LOG_*_EVERY_SECOND
macros (e.g. yadcc/scheduler/task_dispatcher.cc:150)."""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Dict, Tuple

_configured = False


def get_logger(name: str) -> logging.Logger:
    global _configured
    if not _configured:
        level = os.environ.get("YTPU_LOG_LEVEL", "INFO").upper()
        logging.basicConfig(
            stream=sys.stderr,
            level=getattr(logging, level, logging.INFO),
            format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
        )
        _configured = True
    return logging.getLogger(name)


# (logger name, key) -> monotonic time of its last emitted line.
_last_emit: Dict[Tuple[str, str], float] = {}


def log_every_n_seconds(
    logger: logging.Logger, level: int, key: str, msg: str, n: float = 1.0
) -> None:
    """Log ``msg`` unless this logger's ``key`` emitted less than ``n``
    seconds ago.  Kept for parity: only the tests call it, in both
    packages."""
    now = time.monotonic()
    k = (logger.name, key)
    if now - _last_emit.get(k, -1e9) >= n:
        _last_emit[k] = now
        logger.log(level, msg)
