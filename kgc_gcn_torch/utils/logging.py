"""Logging: console + ``<model_dir>/train.log`` with the reference's format
(reference utils.py:80-104)."""

from __future__ import annotations

import logging
import os


def set_logger(log_path: str) -> None:
    """Root logger → console + file, '%(asctime)s [%(levelname)s]' format."""
    logger = logging.getLogger()
    logger.setLevel(logging.INFO)
    if logger.handlers:
        return
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(message)s")
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    fh = logging.FileHandler(log_path)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
