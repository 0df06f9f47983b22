"""One logger for the port's diagnostics (counterpart of
``repro.obs.log``).

Everything routes through one ``logging`` hierarchy rooted at
``"repro_torch"``:

  * ``get_logger("graph_serve")`` → the ``repro_torch.graph_serve``
    logger, writing to stdout as ``[graph_serve] message`` (warnings and
    errors keep their level visible: ``[graph_serve] WARNING: ...``).
  * ``configure(level)`` sets the level (default ``logging.INFO``). The
    reference reads an environment variable for it; the port reads
    none — the CLIs pass a level (``--log-level``).
  * ``deprecated(msg, stacklevel=...)`` is the deprecation funnel: a
    real ``DeprecationWarning`` plus a debug line.

The handler is installed once, on the ``repro_torch`` logger only;
applications embedding the package can replace it.
"""
from __future__ import annotations

import logging
import sys
import warnings

LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}

_configured = False


class _ShortNameFormatter(logging.Formatter):
    """``[graph_serve] message``: the logger's leaf name in brackets;
    warnings and errors name their level."""

    def format(self, record: logging.LogRecord) -> str:
        leaf = record.name.rsplit(".", 1)[-1]
        msg = record.getMessage()
        if record.levelno >= logging.WARNING:
            return f"[{leaf}] {record.levelname}: {msg}"
        return f"[{leaf}] {msg}"


class _StdoutHandler(logging.StreamHandler):
    """Resolves ``sys.stdout`` at emit time, so a stream swapped after
    ``configure`` (pytest's capture, ``redirect_stdout``) still gets the
    output."""

    def __init__(self):
        super().__init__(sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):            # the base __init__ assigns; ignore
        pass


def configure(level=None, stream=None) -> logging.Logger:
    """Install the stdout handler on the ``repro_torch`` logger.
    Idempotent when called with no arguments once installed; a ``level``
    (an int or a name of ``LEVELS``) or a ``stream`` reconfigures."""
    global _configured
    root = logging.getLogger("repro_torch")
    if _configured and level is None and stream is None:
        return root
    if isinstance(level, str):
        if level.lower() not in LEVELS:
            raise ValueError(f"unknown log level {level!r}; expected one "
                             f"of {sorted(LEVELS)}")
        level = LEVELS[level.lower()]
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = (_StdoutHandler() if stream is None
               else logging.StreamHandler(stream))
    handler.setFormatter(_ShortNameFormatter())
    root.addHandler(handler)
    root.setLevel(logging.INFO if level is None else level)
    root.propagate = False
    _configured = True
    return root


def get_logger(name: str = "") -> logging.Logger:
    """The ``repro_torch.<name>`` logger (the package's own for
    ``name=""``), with the stdout handler installed on first use."""
    configure()
    return logging.getLogger(f"repro_torch.{name}" if name
                             else "repro_torch")


def deprecated(message: str, *, stacklevel: int = 2) -> None:
    """A real ``DeprecationWarning`` plus a debug-level log line."""
    # reprolint: disable=RL005 -- the deprecation channel itself
    warnings.warn(message, DeprecationWarning, stacklevel=stacklevel + 1)
    get_logger("deprecation").debug(message)
