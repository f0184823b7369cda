"""Colored logging with stdout/stderr split.

Capability parity with the reference router's logger (reference:
src/vllm_router/log.py:44 `init_logger`): colored level names, one handler for
INFO-and-below on stdout and one for WARNING-and-up on stderr, idempotent
per-module initialisation.
"""

import logging
import os
import sys

_COLORS = {
    "DEBUG": "\033[36m",  # cyan
    "INFO": "\033[32m",  # green
    "WARNING": "\033[33m",  # yellow
    "ERROR": "\033[31m",  # red
    "CRITICAL": "\033[35m",  # magenta
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def __init__(self, use_color: bool = True):
        super().__init__(
            fmt="[%(asctime)s] %(levelname)s %(name)s: %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
        self.use_color = use_color

    def format(self, record: logging.LogRecord) -> str:
        if self.use_color and record.levelname in _COLORS:
            record = logging.makeLogRecord(record.__dict__)
            record.levelname = (
                f"{_COLORS[record.levelname]}{record.levelname}{_RESET}"
            )
        return super().format(record)


class _MaxLevelFilter(logging.Filter):
    def __init__(self, max_level: int):
        super().__init__()
        self.max_level = max_level

    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno <= self.max_level


def init_logger(name: str, level: int | None = None) -> logging.Logger:
    """Create (or return) a logger with colored stdout/stderr handlers."""
    logger = logging.getLogger(name)
    if getattr(logger, "_pst_initialized", False):
        return logger

    env_level = os.environ.get("PST_LOG_LEVEL", "INFO").upper()
    logger.setLevel(level if level is not None else env_level)

    use_color = sys.stdout.isatty()

    stdout_handler = logging.StreamHandler(sys.stdout)
    stdout_handler.setLevel(logging.DEBUG)
    stdout_handler.addFilter(_MaxLevelFilter(logging.INFO))
    stdout_handler.setFormatter(_ColorFormatter(use_color))

    stderr_handler = logging.StreamHandler(sys.stderr)
    stderr_handler.setLevel(logging.WARNING)
    stderr_handler.setFormatter(_ColorFormatter(use_color))

    logger.addHandler(stdout_handler)
    logger.addHandler(stderr_handler)
    logger.propagate = False
    logger._pst_initialized = True  # type: ignore[attr-defined]
    return logger
