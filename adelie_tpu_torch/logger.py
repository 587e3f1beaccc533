"""Logging utilities (reference: adelie/logger.py:5-41)."""

import logging
from contextlib import contextmanager


class CustomFormatter(logging.Formatter):
    grey = "\x1b[38;20m"
    yellow = "\x1b[33;20m"
    red = "\x1b[31;20m"
    bold_red = "\x1b[31;1m"
    reset = "\x1b[0m"
    fmt = "%(asctime)s - %(name)s - %(levelname)s - %(message)s (%(filename)s:%(lineno)d)"

    FORMATS = {
        logging.DEBUG: grey + fmt + reset,
        logging.INFO: grey + fmt + reset,
        logging.WARNING: yellow + fmt + reset,
        logging.ERROR: red + fmt + reset,
        logging.CRITICAL: bold_red + fmt + reset,
    }

    def format(self, record):
        log_fmt = self.FORMATS.get(record.levelno)
        formatter = logging.Formatter(log_fmt)
        return formatter.format(record)


logger = logging.getLogger("adelie_tpu_torch")
logger.setLevel(logging.WARNING)
_ch = logging.StreamHandler()
_ch.setFormatter(CustomFormatter())
logger.addHandler(_ch)


@contextmanager
def logger_level(level):
    """Context manager that temporarily sets the logger level
    (reference adelie/logger.py:34-41)."""
    old = logger.level
    logger.setLevel(level)
    try:
        yield
    finally:
        logger.setLevel(old)
