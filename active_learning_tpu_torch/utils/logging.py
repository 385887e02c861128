"""The port's logger: file + console (as the JAX package's
``utils/logging.py``).  On N ranks each rank writes its own file, and
ranks other than 0 log warnings and above only."""

from __future__ import annotations

import logging
import os

LOGGER_NAME = "ActiveLearningTorch"


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


def setup_logging(directory: str, filename: str,
                  rank: int = 0) -> logging.Logger:
    os.makedirs(directory, exist_ok=True)
    logger = get_logger()
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    fmt = logging.Formatter("%(asctime)s %(message)s")
    file_handler = logging.FileHandler(os.path.join(directory, filename))
    file_handler.setFormatter(fmt)
    logger.addHandler(file_handler)
    logger.addHandler(logging.StreamHandler())
    return logger
