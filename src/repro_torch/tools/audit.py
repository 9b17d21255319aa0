"""The port's data-movement gate: the lint and the serving steps' audit.

Counterpart of the reference's ``tools/audit.py``.  Three sections, each
optional (all three when none is named):

* ``--lint`` — every rule of :mod:`repro_torch.analysis.lint` over the
  port's files (``src/repro_torch/``, ``tests/test_torch_*.py``,
  ``chip_smoke.py``);
* ``--transfer-audit`` (the reference's ``--hlo-audit``) — the olmo-1b
  smoke ``Server`` (2 slots x 48, prefill chunk 4) serves one request and
  spills and restores its slot; its build's ``audit_reports`` (decode,
  prefill, insert), and on a card one profiled decode replay, one
  profiled prefill replay and one profiled restore, their copy records
  read from the card's trace;
* ``--selftest`` — the gate must trip: one injected case of each class
  (the AST rules and a pragma that silences one, a retired name, the
  fault-raise rule and its one-file allowlist, a missed in-place update,
  a written read-only role, a replaced streamed source, copies over the
  allowance), and the clean case stays clean.

Writes ``--out`` (the JSON report) and exits 1 on any error or selftest
miss.  Run from the repo root::

    PYTHONPATH=src python -m repro_torch.tools.audit --lint --selftest \\
        --transfer-audit --out build/audit_report.json

The transfer audit runs on the card, and raises when none is visible;
``--device cpu`` runs its storage and version checks on the CPU, where
there are no copy records to read (the report's ``device`` says which).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

REPO = pathlib.Path(__file__).resolve().parents[3]


# ---------------------------------------------------------------------------
# --lint
# ---------------------------------------------------------------------------

def run_lint() -> dict:
    from repro_torch.analysis import lint

    violations = lint.lint_repo(REPO)
    for v in violations:
        print(f"  {v}")
    return {"violations": [v.to_json() for v in violations],
            "rules": sorted(lint.registered_rules()),
            "files": len(lint.port_files(REPO)),
            "ok": not any(v.severity == "error" for v in violations)}


# ---------------------------------------------------------------------------
# --transfer-audit
# ---------------------------------------------------------------------------

def _print_report(name: str, r: dict) -> None:
    by_dir = r["bytes_by_direction"]
    print(f"  {name}: in place {r['donation_materialized']}/{r['donation_expected']}, "
          f"host bytes {r['host_transfer_bytes']:.0f} (H2D {by_dir.get('HtoD', 0):.0f}, "
          f"D2H {by_dir.get('DtoH', 0):.0f}; {'profiled' if r['profiled'] else 'no trace'}), "
          f"{len(r['violations'])} violation(s)")
    for v in r["violations"]:
        print(f"    [{v['severity']}] {v['kind']} {v['op']}: {v['detail']}")


def run_transfer_audit(device: str | None = None) -> dict:
    import dataclasses

    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.configs import smoke_config
    from repro_torch.models.model_zoo import ModelBundle
    from repro_torch.serve import Request, ServeConfig, Server

    dev = resolve_device(device)
    # float32 throughout, as the reference's gate serves it: weights and cache
    bundle = ModelBundle(dataclasses.replace(smoke_config("olmo-1b"), dtype="float32"))
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    cfg = ServeConfig(batch_slots=2, max_len=48, prefill_chunk=4)
    srv = Server(bundle, cfg, params, device=dev)
    eng = srv.engine
    # one request (its prefill dispatch and decode steps), then a spill and
    # restore of its slot: eagerly each step's first run is the build's
    # audit of it, and the first restore the insert's
    srv.add_requests([Request(rid=0, prompt=np.arange(1, 8), max_new_tokens=2)])
    srv.run_until_done()
    spill_to = srv.runtime.spill_placement()
    eng.insert_slot(0, eng.extract_slot(0, spill_to))
    reports = {f"build:{name}": rep.to_json() for name, rep in eng.audit_reports.items()}
    if dev.type == "cuda":
        rows = eng.extract_slot(0, spill_to)
        reports["restore:insert"] = eng.audit_dispatch("insert", rows=rows).to_json()
        reports["replay:decode"] = eng.audit_dispatch("decode", profile=True).to_json()
        B, C = cfg.batch_slots, cfg.prefill_chunk
        eng.stage_prefill(np.ones((B, C), np.int32), np.full(B, C, np.int32),
                          np.zeros(B, np.int32))
        reports["replay:prefill"] = eng.audit_dispatch("prefill", profile=True).to_json()
    for name, r in reports.items():
        _print_report(name, r)
    return {"executables": reports, "device": str(dev),
            "ok": all(r["ok"] for r in reports.values())}


# ---------------------------------------------------------------------------
# --selftest: the gate must trip on one injected case of each class
# ---------------------------------------------------------------------------

#: one violation per AST rule: a zero-copy mirror of a mutated buffer and a
#: blocking fetch in a hot function
_LINT_FIXTURE = """\
import numpy as np
import torch


class HostMirrorRace:
    def build(self):
        self.mirror = np.zeros(8, np.float32)
        return torch.from_numpy(self.mirror)      # shares the buffer ...

    def poke(self):
        self.mirror[0] = 1.0                      # ... which is mutated


def decode_step(t):
    return t.item()                               # a fetch per token
"""

#: the one-file allowlist the fault-raise rule must keep
_HARNESS = "src/repro_torch/core/faults.py"


def _pragma(rule: str) -> str:
    # assembled, so that no lint reads this file's text as a pragma
    return "  # repro: " + "lint-disable=" + rule


def _lint_checks() -> dict[str, bool]:
    from repro_torch.analysis import lint

    results = {}
    found = {v.rule for v in lint.lint_source(
        _LINT_FIXTURE, "src/repro_torch/serve/_injected_fixture.py")}
    for rule in ("mutated-host-mirror-alias", "blocking-transfer-in-hot-path"):
        results[f"lint:{rule}"] = rule in found
    silenced = _LINT_FIXTURE.replace(
        "return t.item()", "return t.item()" + _pragma("blocking-transfer-in-hot-path"))
    results["lint:pragma-suppresses"] = "blocking-transfer-in-hot-path" not in {
        v.rule for v in lint.lint_source(silenced, "src/repro_torch/serve/x.py")}
    retired = "x = " + "POLI" + "CIES" + "['kv_host']\n"
    results["lint:deprecated-pattern"] = "deprecated-policies" in {
        v.rule for v in lint.lint_source(retired, "src/repro_torch/y.py")}
    raise_src = "raise " + "TierLoss" + "Error('host')\n"
    results["lint:injected-fault-raise"] = "injected-fault-raise" in {
        v.rule for v in lint.lint_source(raise_src, "src/repro_torch/serve/x.py")}
    results["lint:injected-fault-allow-in-harness"] = "injected-fault-raise" not in {
        v.rule for v in lint.lint_source(raise_src, _HARNESS)}
    results["lint:injected-fault-allowlist-scoped"] = (
        lint.get_rule("injected-fault-raise").allow == frozenset({_HARNESS}))
    return results


def _audit_checks() -> dict[str, bool]:
    from repro_torch.analysis.transfer_audit import (
        ExpectedMovement,
        RoleExpectation,
        StepTarget,
        audit_step,
    )
    from repro_torch.core.op_analysis import TransferStat

    def kinds(step, trees, roles, records=None, allow=0.0):
        rep = audit_step(StepTarget(step, trees, records=records),
                         ExpectedMovement(roles=roles, host_bytes_allowed=allow,
                                          label="selftest"))
        return {v.kind for v in rep.violations}, rep.ok

    cache, params = torch.zeros(64), torch.ones(8)
    kv_in_place = (RoleExpectation("kv_cache", "caches", donate=True),)
    kv_streamed = (RoleExpectation("kv_cache", "caches", donate=False,
                                   placement_writes=True),)
    read_only = (RoleExpectation("params", "p", donate=False),)
    results = {}
    # a step that rebuilds its cache instead of writing it in place
    got, _ = kinds(lambda: {"caches": cache + 1}, {"caches": cache}, kv_in_place)
    results["audit:missed-donation"] = "missed-donation" in got
    # a step that writes the params it may only read
    def writes_params():
        params.mul_(1.0)

    got, _ = kinds(writes_params, {"p": params}, read_only)
    results["audit:forbidden-donation-written"] = "forbidden-donation" in got
    # a step that replaces a streamed cache's host source
    host = torch.zeros(16)

    def replaces_source():
        host.set_(torch.zeros(16))

    got, _ = kinds(replaces_source, {"caches": host}, kv_streamed)
    results["audit:forbidden-donation-replaced"] = "forbidden-donation" in got
    # copies over the allowance
    records = [TransferStat("Memcpy DtoH (Device -> Pinned)", "DtoH", 4096.0,
                            "device", "host")]
    got, _ = kinds(lambda: None, {"caches": cache}, kv_in_place, records, allow=24.0)
    results["audit:stray-host-transfer"] = "stray-host-transfer" in got
    # the clean case: an in-place write, a streamed write-back, and copies
    # within the allowance
    _, ok = kinds(lambda: {"caches": cache.add_(1)}, {"caches": cache, "p": params},
                  kv_in_place + read_only, records, allow=4096.0)
    _, ok2 = kinds(lambda: {"caches": host.add_(1)}, {"caches": host}, kv_streamed)
    results["audit:clean-passes"] = ok and ok2
    return results


def run_selftest() -> dict:
    results = {**_lint_checks(), **_audit_checks()}
    for name, ok in sorted(results.items()):
        print(f"  {'PASS' if ok else 'FAIL'} {name}")
    return {"checks": results, "ok": all(results.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lint", action="store_true")
    ap.add_argument("--transfer-audit", action="store_true")
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the transfer audit's device (default: the card; cpu runs "
                         "its storage and version checks only)")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="write the JSON report here")
    args = ap.parse_args(argv)
    if not (args.lint or args.transfer_audit or args.selftest):
        args.lint = args.transfer_audit = args.selftest = True

    report: dict = {}
    ok = True
    if args.lint:
        print("== lint ==")
        report["lint"] = run_lint()
        ok &= report["lint"]["ok"]
    if args.selftest:
        print("== selftest (injected violations must be caught) ==")
        report["selftest"] = run_selftest()
        ok &= report["selftest"]["ok"]
    if args.transfer_audit:
        print("== transfer audit (olmo-1b smoke serve executor) ==")
        report["transfer_audit"] = run_transfer_audit(args.device)
        ok &= report["transfer_audit"]["ok"]
    report["ok"] = ok
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=2, sort_keys=True))
        print(f"wrote {args.out}")
    print("audit", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
