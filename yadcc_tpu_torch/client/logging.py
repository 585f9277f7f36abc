"""Zero-dependency leveled stderr logger for the client (a copy of the
JAX package's yadcc_tpu/client/logging.py).

Parity with reference yadcc/client/common/logging.{h,cc}: the client
runs once per TU and must not pay for logging frameworks; level comes
from YTPU_LOG_LEVEL.  Every line starts with ``ytpu-client LEVEL:``, so
a build log tells the client's own words from the compiler's."""

from __future__ import annotations

import sys

from .env_options import log_level

_LEVELS = {"DEBUG": 10, "INFO": 20, "WARNING": 30, "ERROR": 40}


def _emit(level: str, msg: str) -> None:
    if _LEVELS.get(level, 0) >= _LEVELS.get(log_level(), 30):
        print(f"ytpu-client {level}: {msg}", file=sys.stderr)


def debug(msg: str) -> None:
    _emit("DEBUG", msg)


def info(msg: str) -> None:
    _emit("INFO", msg)


def warning(msg: str) -> None:
    _emit("WARNING", msg)


def error(msg: str) -> None:
    _emit("ERROR", msg)
