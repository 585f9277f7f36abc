"""Leveled stderr logging, configured once per process (level from
YTPU_LOG_LEVEL); parity with the reference's zero-dependency stderr
logger (yadcc/client/common/logging.{h,cc})."""

from __future__ import annotations

import logging
import os
import sys

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
