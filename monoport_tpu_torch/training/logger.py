"""Colored console + file logger (copy of ``monoport_tpu/training/logger.py``;
reference monoport/lib/common/logger.py:18-50)."""

from __future__ import annotations

import logging
import os

_COLORS = {
    logging.DEBUG: "\033[37m",
    logging.INFO: "\033[32m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"


def colorlogger(log_dir: str = ".", log_name: str = "train_logs.txt",
                name: str = "monoport_tpu_torch") -> logging.Logger:
    """ANSI-colored console logger + append-mode file log."""
    logger = logging.getLogger(f"{name}:{log_dir}")
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    logger.propagate = False

    console = logging.StreamHandler()
    console.setFormatter(_ColorFormatter(
        "%(asctime)s %(levelname)s %(message)s", datefmt="%H:%M:%S"))
    logger.addHandler(console)

    os.makedirs(log_dir, exist_ok=True)
    fileh = logging.FileHandler(os.path.join(log_dir, log_name), mode="a")
    fileh.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(fileh)
    return logger
