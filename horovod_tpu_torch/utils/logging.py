"""Leveled, rank-prefixed logging (port of horovod_tpu/utils/logging.py).

Capability parity with upstream Horovod's C++ logging
(logging.h/logging.cc): the level from ``HOROVOD_LOG_LEVEL``
(trace/debug/info/warning/error/fatal), the timestamp dropped under
``HOROVOD_LOG_HIDE_TIME``; each line carries this process's rank, or "-"
before ``init()``.
"""

from __future__ import annotations

import logging
import sys

from ..core import config as _config

_LEVELS = {
    "trace": 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "fatal": logging.CRITICAL,
}

logging.addLevelName(5, "TRACE")

_logger: logging.Logger | None = None


def get_logger() -> logging.Logger:
    global _logger
    if _logger is not None:
        return _logger
    logger = logging.getLogger("horovod_tpu_torch")
    level_name = (_config.get_env(_config.LOG_LEVEL) or "warning").lower()
    logger.setLevel(_LEVELS.get(level_name, logging.WARNING))
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        if _config.get_bool(_config.LOG_HIDE_TIME):
            fmt = "[%(levelname)s] %(message)s"
        else:
            fmt = "%(asctime)s [%(levelname)s] %(message)s"
        handler.setFormatter(logging.Formatter(fmt))
        logger.addHandler(handler)
    logger.propagate = False
    _logger = logger
    return logger


def _log(level: int, msg: str, *args) -> None:
    get_logger().log(level, f"[{_rank_prefix()}]: {msg}", *args)


def _rank_prefix() -> str:
    # Late import to avoid a cycle; before init() the rank is "-".
    from ..core.state import global_state
    return str(global_state.rank) if global_state.initialized else "-"


def trace(msg: str, *args) -> None:
    _log(5, msg, *args)


def debug(msg: str, *args) -> None:
    _log(logging.DEBUG, msg, *args)


def info(msg: str, *args) -> None:
    _log(logging.INFO, msg, *args)


def warning(msg: str, *args) -> None:
    _log(logging.WARNING, msg, *args)


def error(msg: str, *args) -> None:
    _log(logging.ERROR, msg, *args)
