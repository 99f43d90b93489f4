"""Structured logging: standard `logging` with one shared formatter,
quiet by default, DEBUG via DEFER_TPU_LOGLEVEL (the same variable the
JAX package reads)."""

from __future__ import annotations

import logging
import os

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    global _CONFIGURED
    if not _CONFIGURED:
        level = os.environ.get("DEFER_TPU_LOGLEVEL", "WARNING").upper()
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            )
        )
        root = logging.getLogger("defer_tpu_torch")
        root.addHandler(handler)
        root.setLevel(level)
        root.propagate = False
        _CONFIGURED = True
    return logging.getLogger(name)
