"""Minimal structured logging on the standard library.

As the JAX package's ``get_logger``: one stream handler per logger, its level
from the environment variable ``FUSION_TPU_LOG`` (default WARNING)."""
from __future__ import annotations

import logging
import os


def get_logger(name: str = "fusion_tpu") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(os.environ.get("FUSION_TPU_LOG", "WARNING").upper())
    return logger
