"""Run logging: colored console + timestamped file (port of
flatquant_tpu/utils/logging_utils.py; args_utils.py:164-190 analog)."""

from __future__ import annotations

import logging
import os
import sys
import time


class _Color(logging.Formatter):
    COLORS = {
        logging.DEBUG: "\x1b[36m",
        logging.INFO: "\x1b[32m",
        logging.WARNING: "\x1b[33m",
        logging.ERROR: "\x1b[31m",
    }
    RESET = "\x1b[0m"

    def format(self, record):
        base = super().format(record)
        color = self.COLORS.get(record.levelno, "")
        return f"{color}{base}{self.RESET}" if sys.stderr.isatty() else base


def create_logger(exp_dir: str, name: str = "flatquant_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = "[%(asctime)s] %(levelname)s %(message)s"
    ch = logging.StreamHandler()
    ch.setFormatter(_Color(fmt, datefmt="%H:%M:%S"))
    logger.addHandler(ch)
    if exp_dir:
        os.makedirs(exp_dir, exist_ok=True)
        ts = time.strftime("%Y%m%d_%H%M%S")
        fh = logging.FileHandler(os.path.join(exp_dir, f"log_{ts}.txt"))
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    logger.propagate = False
    return logger
