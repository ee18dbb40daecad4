"""Logging helpers.

Reference: `core/env/src/main/scala/Logging.scala:14-23` (log4j logger with
config-derived root). A copy of mmlspark_tpu/core/logging.py: std-lib
logging under root "mmlspark_tpu_torch", level from config key `log.level`
(env MMLSPARK_TPU_LOG__LEVEL), format from `log.format`
(env MMLSPARK_TPU_LOG__FORMAT) — "text" (default) or "json".

The JSON formatter writes one object per record. Trace context (span and
batch ids) joins it when the port gains observability.

The first `get_logger` call configures the root once; `set_level` and
`reconfigure` re-open that decision at runtime (the original module
latched `_configured` forever, so a config change after the first log
line was silently ignored).
"""

from __future__ import annotations

import json
import logging

from .config import get_config

__all__ = ["get_logger", "set_level", "reconfigure", "JsonFormatter"]

_ROOT = "mmlspark_tpu_torch"
_configured = False
_handler: "logging.Handler | None" = None


class JsonFormatter(logging.Formatter):
    """One JSON object per line; opt-in via log.format=json."""

    def format(self, record: logging.LogRecord) -> str:
        doc = {
            "ts": self.formatTime(record),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            doc["exc"] = self.formatException(record.exc_info)
        return json.dumps(doc)


def _make_formatter() -> logging.Formatter:
    fmt = str(get_config("log.format", "text")).lower()
    if fmt == "json":
        return JsonFormatter()
    return logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")


def _configure() -> None:
    global _configured, _handler
    if _configured:
        return
    logger = logging.getLogger(_ROOT)
    if not logger.handlers:
        _handler = logging.StreamHandler()
        _handler.setFormatter(_make_formatter())
        logger.addHandler(_handler)
    level = str(get_config("log.level", "WARNING")).upper()
    logger.setLevel(getattr(logging, level, logging.WARNING))
    logger.propagate = False
    _configured = True


def reconfigure() -> None:
    """Re-read log.level and log.format from config and re-apply them —
    the un-latch for `_configured` (config edits after the first log line
    take effect here)."""
    global _configured
    _configure()
    logger = logging.getLogger(_ROOT)
    level = str(get_config("log.level", "WARNING")).upper()
    logger.setLevel(getattr(logging, level, logging.WARNING))
    if _handler is not None:
        _handler.setFormatter(_make_formatter())
    _configured = True


def set_level(level: "str | int") -> None:
    """Set the root level directly (accepts "DEBUG"/"info"/logging.INFO)."""
    _configure()
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.WARNING)
    logging.getLogger(_ROOT).setLevel(level)


def get_logger(name: str | None = None) -> logging.Logger:
    _configure()
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)
