"""Leveled, colored logging (port of ``libdwt_tpu.utils.log``).

The stdlib ``logging`` with an ANSI formatter on a terminal; ``fatal``
logs and exits, like the reference's aborting error helper.
"""
from __future__ import annotations

import logging
import sys
from typing import NoReturn

__all__ = ["get_logger", "fatal", "set_level"]

_COLORS = {
    logging.DEBUG: "\033[37m",      # white
    logging.INFO: "\033[32m",       # green
    logging.WARNING: "\033[33m",    # yellow
    logging.ERROR: "\033[31m",      # red
    logging.CRITICAL: "\033[1;31m", # bold red
}
_RESET = "\033[0m"


class _AnsiFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        if sys.stderr.isatty():
            return f"{_COLORS.get(record.levelno, '')}{msg}{_RESET}"
        return msg


_logger: logging.Logger | None = None


def get_logger() -> logging.Logger:
    """The ``libdwt_torch`` logger, with its own stderr handler."""
    global _logger
    if _logger is None:
        lg = logging.getLogger("libdwt_torch")
        if not lg.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(_AnsiFormatter("%(levelname)s %(name)s: %(message)s"))
            lg.addHandler(h)
            lg.setLevel(logging.INFO)
            # a dedicated handler is attached: do not also bubble to root
            # (an app's basicConfig would print every line twice)
            lg.propagate = False
        _logger = lg
    return _logger


def set_level(level) -> None:
    get_logger().setLevel(level)


def fatal(msg: str, *args) -> NoReturn:
    """Log at CRITICAL and exit with status 1."""
    get_logger().critical(msg, *args)
    raise SystemExit(1)
