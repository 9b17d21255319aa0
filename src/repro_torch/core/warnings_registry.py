"""Warn-once registry: the port's copy of ``repro/analysis/warnings_registry.py``.

Every once-per-process warning of the port registers here under a
namespaced key (``axis_link:<axis>``), so a test can reset it and observe
the warning again.
"""

from __future__ import annotations

import threading
import warnings as _warnings

_LOCK = threading.Lock()
_SEEN: set[str] = set()


def warn_once(
    key: str,
    message: str,
    category: type[Warning] = UserWarning,
    stacklevel: int = 3,
) -> bool:
    """Emit ``message`` the first time ``key`` is seen; return whether the
    warning fired.  Thread-safe; reset via :func:`reset_warnings`."""
    with _LOCK:
        if key in _SEEN:
            return False
        _SEEN.add(key)
    _warnings.warn(message, category, stacklevel=stacklevel)
    return True


def reset_warnings() -> None:
    """Forget every fired key."""
    with _LOCK:
        _SEEN.clear()
