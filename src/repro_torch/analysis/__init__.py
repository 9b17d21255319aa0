"""Analysis of the port's data movement: a lint and a transfer audit.

Counterpart of ``repro/analysis`` (its ``__init__.py:30-48``).  The
paper's point is that on a tightly coupled system *where bytes move*
decides the speed, and that transparent access makes a wrong move silent.
Two layers make those moves loud:

* :mod:`repro_torch.analysis.lint` — an ``ast`` rule registry over the
  port's own files (blocking fetches on the serve path, zero-copy host
  mirrors of mutated buffers, injected-fault raises, retired names), with
  per-rule allowlists and ``# repro: lint-disable=<rule>`` pragmas;
* :mod:`repro_torch.analysis.transfer_audit` — each serving step checked
  against the placement: caches written in place, read-only and streamed
  roles left alone, and on a card the step's host<->device copies, read
  from the card's own profiler records, within the policy's allowance.

The shared warn-once registry lives at
:mod:`repro_torch.core.warnings_registry` and is re-exported here, as the
reference's package does.  ``lint`` and ``transfer_audit`` load lazily.
"""

from __future__ import annotations

from repro_torch.core.warnings_registry import (  # noqa: F401
    mark,
    reset_warnings,
    warn_once,
)

_LAZY = {
    "lint": "repro_torch.analysis.lint",
    "transfer_audit": "repro_torch.analysis.transfer_audit",
}

__all__ = ["warn_once", "mark", "reset_warnings", "lint", "transfer_audit"]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
