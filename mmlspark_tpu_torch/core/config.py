"""Configuration namespace.

Reference: `core/env/src/main/scala/Configuration.scala:18-47` — Typesafe
config under the `mmlspark.*` namespace with env overrides. A copy of
mmlspark_tpu/core/config.py: a process-wide dict seeded from
`MMLSPARK_TPU_*` environment variables (the same namespace as the JAX
package), with dotted-key get/set; stage `Param`s remain the primary config
surface.
"""

from __future__ import annotations

import os
import threading
from typing import Any

__all__ = ["get_config", "set_config", "config_snapshot"]

_ENV_PREFIX = "MMLSPARK_TPU_"
_lock = threading.Lock()
_config: dict[str, Any] = {}
_loaded = False


def _load_env() -> None:
    global _loaded
    if _loaded:
        return
    with _lock:
        if _loaded:
            return
        for key, val in os.environ.items():
            if key.startswith(_ENV_PREFIX):
                dotted = key[len(_ENV_PREFIX):].lower().replace("__", ".")
                _config.setdefault(dotted, _coerce(val))
        _loaded = True


def _coerce(val: str) -> Any:
    for conv in (int, float):
        try:
            return conv(val)
        except ValueError:
            pass
    if val.lower() in ("true", "false"):
        return val.lower() == "true"
    return val


def get_config(key: str, default: Any = None) -> Any:
    _load_env()
    return _config.get(key, default)


def set_config(key: str, value: Any) -> None:
    _load_env()
    with _lock:
        _config[key] = value


def config_snapshot() -> dict[str, Any]:
    _load_env()
    return dict(_config)
