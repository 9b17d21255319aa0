"""Replay validation: predicted-vs-measured times, per calibrated term.

Counterpart of ``repro/core/replay.py``, copied whole (pure Python); its
JSON is the reference's.

The paper's figures are all of one shape — a theoretical bound next to an
achieved measurement, per datapath (Figs. 3, 5-9).  This module is that
shape as infrastructure: every operation we can both *predict* (from the
:mod:`repro_torch.core.datapath` bounds under the active system) and
*measure* (calibration sweeps) is recorded as a :class:`ReplayRecord`,
grouped by the hardware term that dominates its prediction, and
summarized as per-term relative error with the limiting link attached.

The summary drives a drift gate (:meth:`ReplayLog.gate`): when the cost
model's prediction for a term diverges from what the card actually does
by more than a threshold, the gate fails instead of letting the model
keep pricing with stale constants.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterable, Mapping

__all__ = [
    "ReplayRecord",
    "TermError",
    "ReplayLog",
]

#: records kept verbatim per term; aggregates keep counting past the cap
_MAX_RECORDS_PER_TERM = 256

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class ReplayRecord:
    """One predicted-vs-measured observation.

    ``term`` names the calibrated constant the prediction leans on
    (e.g. ``hbm_bandwidth``, ``ici_link_bandwidth``, ``decode_step``);
    ``limiting_link`` is the datapath segment the bound said would
    dominate; ``source`` says which harness produced the measurement
    (``executor``, ``bench_membw``, ``calibrate``...).
    """

    term: str
    name: str
    predicted_s: float
    measured_s: float
    nbytes: int = 0
    limiting_link: str = ""
    source: str = ""

    @property
    def rel_error(self) -> float:
        """|predicted - measured| / measured (symmetric enough for a
        gate; guarded against zero-length measurements)."""
        return abs(self.predicted_s - self.measured_s) / max(
            self.measured_s, _EPS
        )

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: Mapping) -> "ReplayRecord":
        return cls(**{f.name: obj[f.name] for f in dataclasses.fields(cls)
                      if f.name in obj})


@dataclasses.dataclass
class TermError:
    """Running per-term aggregate over every record ever seen."""

    term: str
    count: int = 0
    mean_rel_error: float = 0.0
    max_rel_error: float = 0.0
    worst_name: str = ""
    limiting_link: str = ""

    def update(self, rec: ReplayRecord) -> None:
        err = rec.rel_error
        self.count += 1
        self.mean_rel_error += (err - self.mean_rel_error) / self.count
        if err >= self.max_rel_error:
            self.max_rel_error = err
            self.worst_name = rec.name
            self.limiting_link = rec.limiting_link or self.limiting_link

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class ReplayLog:
    """Accumulates :class:`ReplayRecord` s and answers the gate question.

    Verbatim records are capped per term (aggregates are exact over the
    full stream) so a long serve soak cannot grow the log unboundedly.
    """

    def __init__(self) -> None:
        self._records: dict[str, list[ReplayRecord]] = {}
        self._errors: dict[str, TermError] = {}

    # -- recording --------------------------------------------------------
    def record(
        self,
        term: str,
        name: str,
        predicted_s: float,
        measured_s: float,
        *,
        nbytes: int = 0,
        limiting_link: str = "",
        source: str = "",
    ) -> ReplayRecord:
        rec = ReplayRecord(
            term=term,
            name=name,
            predicted_s=float(predicted_s),
            measured_s=float(measured_s),
            nbytes=int(nbytes),
            limiting_link=str(limiting_link),
            source=source,
        )
        self.add(rec)
        return rec

    def add(self, rec: ReplayRecord) -> None:
        if rec.measured_s <= 0.0:
            return  # clock glitch / unmeasured: nothing to validate
        bucket = self._records.setdefault(rec.term, [])
        if len(bucket) < _MAX_RECORDS_PER_TERM:
            bucket.append(rec)
        self._errors.setdefault(rec.term, TermError(rec.term)).update(rec)

    def extend(self, recs: Iterable[ReplayRecord]) -> None:
        for rec in recs:
            self.add(rec)

    # -- reporting --------------------------------------------------------
    def __len__(self) -> int:
        return sum(e.count for e in self._errors.values())

    @property
    def terms(self) -> tuple[str, ...]:
        return tuple(sorted(self._errors))

    def records(self, term: str | None = None) -> list[ReplayRecord]:
        if term is not None:
            return list(self._records.get(term, ()))
        return [r for t in sorted(self._records) for r in self._records[t]]

    def per_term_error(self) -> dict[str, TermError]:
        return {t: self._errors[t] for t in sorted(self._errors)}

    def report(self) -> str:
        """Human-readable per-term table (the CI artifact's text form)."""
        lines = [
            f"{'term':<22} {'n':>5} {'mean err':>9} {'max err':>9} "
            f"{'link':<8} worst"
        ]
        for term, err in self.per_term_error().items():
            lines.append(
                f"{term:<22} {err.count:>5d} {err.mean_rel_error:>8.1%} "
                f"{err.max_rel_error:>8.1%} {err.limiting_link:<8} "
                f"{err.worst_name}"
            )
        if len(lines) == 1:
            lines.append("(no replay records)")
        return "\n".join(lines)

    def gate(
        self,
        default_threshold: float,
        per_term: Mapping[str, float] | None = None,
    ) -> list[str]:
        """Drift-gate violations: terms whose *mean* relative error
        exceeds their threshold.  Empty list == gate passes."""
        per_term = dict(per_term or {})
        violations = []
        for term, err in self.per_term_error().items():
            threshold = per_term.get(term, default_threshold)
            if err.mean_rel_error > threshold:
                violations.append(
                    f"{term}: mean rel error {err.mean_rel_error:.1%} > "
                    f"gate {threshold:.1%} (n={err.count}, worst "
                    f"{err.worst_name} at {err.max_rel_error:.1%})"
                )
        return violations

    # -- persistence ------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "errors": {t: e.to_json() for t, e in self._errors.items()},
            "records": [r.to_json() for r in self.records()],
        }

    @classmethod
    def from_json(cls, obj: Mapping) -> "ReplayLog":
        log = cls()
        log.extend(ReplayRecord.from_json(r) for r in obj.get("records", ()))
        # aggregates rebuilt from records may undercount a capped stream;
        # prefer the persisted exact aggregates when present
        for term, e in obj.get("errors", {}).items():
            fields = {f.name for f in dataclasses.fields(TermError)}
            log._errors[term] = TermError(
                **{k: v for k, v in {**e, "term": term}.items()
                   if k in fields}
            )
        return log

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.to_json(), indent=2) + "\n")
        return path

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "ReplayLog":
        return cls.from_json(json.loads(pathlib.Path(path).read_text()))
