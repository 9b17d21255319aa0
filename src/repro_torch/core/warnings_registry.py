"""Warn-once registry: the port's copy of ``repro/analysis/warnings_registry.py``.

Every once-per-process warning of the port registers here under a
namespaced key (``axis_link:<axis>``, ``decode_replay:<model>``), so a
test can reset it and observe the warning again.
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


def mark(key: str) -> bool:
    """Register ``key`` without emitting anything (for once-only side
    effects that are not ``warnings.warn``, such as a log line).  Returns
    True the first time, False after."""
    with _LOCK:
        if key in _SEEN:
            return False
        _SEEN.add(key)
        return True


def reset_warnings(prefix: str | None = None) -> None:
    """Forget fired keys (all, or those under ``prefix:``/exact match)."""
    with _LOCK:
        if prefix is None:
            _SEEN.clear()
        else:
            _SEEN.difference_update(
                {k for k in _SEEN if k == prefix or k.startswith(prefix + ":")})
