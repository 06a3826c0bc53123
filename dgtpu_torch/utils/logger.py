"""Console + rotating-file logger.

Mirrors the observability surface of the reference (``utils/logger.py``):
a named logger with a configurable level from the paramfile
(``logging.loglevel``) and an optional 1 MB x 10 rotating ``logs/debug.log``
(``logging.write_to_file``).  We use stdlib logging with an ANSI color
formatter instead of the ``coloredlogs`` dependency.
"""

import logging
import os
from logging.handlers import RotatingFileHandler

_COLORS = {
    "DEBUG": "\033[36m",
    "INFO": "\033[32m",
    "WARNING": "\033[33m",
    "ERROR": "\033[31m",
    "CRITICAL": "\033[1;31m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and os.isatty(2):
            return f"{color}{msg}{_RESET}"
        return msg


class Logger:
    """``Logger(__name__, settings).logger`` — same call surface as the reference."""

    def __init__(self, name, settings=None):
        self.logger = logging.getLogger(name)
        loglevel = "INFO"
        write_to_file = False
        if settings is not None:
            try:
                loglevel = settings.logging.loglevel
                write_to_file = settings.logging.write_to_file
            except AttributeError:
                pass
        self.logger.setLevel(getattr(logging, str(loglevel).upper(), logging.INFO))
        if not self.logger.handlers:
            sh = logging.StreamHandler()
            sh.setFormatter(_ColorFormatter(
                "%(asctime)s %(name)s[%(process)d] %(levelname)s %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S"))
            self.logger.addHandler(sh)
            if write_to_file:
                os.makedirs("logs", exist_ok=True)
                fh = RotatingFileHandler(
                    os.path.join("logs", "debug.log"),
                    maxBytes=1024 * 1024, backupCount=10)
                fh.setFormatter(logging.Formatter(
                    "%(asctime)s %(name)s[%(process)d] %(levelname)s %(message)s"))
                self.logger.addHandler(fh)
        self.logger.propagate = False
