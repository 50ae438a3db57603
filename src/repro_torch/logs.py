"""Logging for the ``repro_torch.*`` hierarchy — env-gated, silent by default.

The library never configures the root logger and never prints unless asked:
every module calls ``get_logger("store")`` (→ ``repro_torch.store``) and logs into
a hierarchy rooted at ``repro_torch``, which carries a ``NullHandler``. Setting

    REPRO_LOG=debug            # or info / warning / error

attaches a single stderr handler to the ``repro_torch`` root at that level, so
fleet workers, chaos events, prefetch failures, and store GC become visible
without touching application logging config. ``REPRO_LOG=debug:fleet``
scopes the verbosity to one subtree (``repro_torch.fleet``) and leaves the rest at
warning.

Programmatic use: ``configure("debug")`` does the same thing as the env var
and is idempotent — repeated calls replace the level, not stack handlers.
"""
from __future__ import annotations

import logging
import os
import sys

ROOT = "repro_torch"

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}

_handler: logging.Handler | None = None
_env_applied = False


def get_logger(name: str = "") -> logging.Logger:
    """Return ``repro_torch.<name>`` (or the root for an empty name)."""
    _apply_env_once()
    return logging.getLogger(f"{ROOT}.{name}" if name else ROOT)


def configure(spec: str | None = None, *, stream=None) -> logging.Logger:
    """Attach/adjust the single stderr handler per ``spec``.

    ``spec`` is ``<level>`` or ``<level>:<subtree>`` (e.g. ``debug:fleet``).
    ``None``/empty removes the handler and restores library silence.
    """
    global _handler
    root = logging.getLogger(ROOT)
    if not any(isinstance(h, logging.NullHandler) for h in root.handlers):
        root.addHandler(logging.NullHandler())
    if _handler is not None:
        for logger in _all_repro_loggers():
            logger.removeHandler(_handler)
        _handler = None
    if not spec:
        return root
    level_name, _, subtree = str(spec).partition(":")
    level = _LEVELS.get(level_name.strip().lower(), logging.INFO)
    target = logging.getLogger(f"{ROOT}.{subtree}" if subtree else ROOT)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s")
    )
    target.addHandler(handler)
    target.setLevel(level)
    _handler = handler
    return target


def _all_repro_loggers() -> list[logging.Logger]:
    out = [logging.getLogger(ROOT)]
    for name in list(logging.Logger.manager.loggerDict):
        if name.startswith(ROOT + "."):
            logger = logging.getLogger(name)
            out.append(logger)
    return out


def _apply_env_once() -> None:
    global _env_applied
    if _env_applied:
        return
    _env_applied = True
    spec = os.environ.get("REPRO_LOG", "")
    if spec:
        configure(spec)
