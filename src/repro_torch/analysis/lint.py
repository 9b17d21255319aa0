"""An ``ast`` lint of the port's own code: the data-movement discipline.

Counterpart of ``repro/analysis/lint.py``: the same framework (a registry
of rules, each with its own allowlist and path filter, checked over the
parsed AST or the raw source) with each rule given its PyTorch meaning,
over the port's files: :data:`SCAN_DIRS` is ``src/repro_torch/``,
``tests/test_torch_*.py`` and ``chip_smoke.py``.

Suppression, as in the reference:

* per line — a trailing ``# repro: lint-disable=<rule>[,<rule>...]`` on
  the offending line;
* per file — the same pragma alone on a comment line anywhere in the file;
* per rule — repo-relative paths in the rule's allowlist.

The rules:

* ``mutated-host-mirror-alias`` — ``torch.from_numpy`` /
  ``torch.as_tensor`` / ``np.asarray`` of a buffer the same class later
  mutates: each shares the buffer's memory, so the mutation changes data
  already handed to a step (the reference's ``jnp.asarray`` race).
* ``blocking-transfer-in-hot-path`` — ``.item()``, ``.cpu()``,
  ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``,
  ``<stream>.synchronize()`` and the scalar casts ``float()`` / ``int()``
  inside a step/decode function of
  ``src/repro_torch/serve/``: each waits for the card on the per-token
  path.  The one sanctioned fetch, the packed ``(2, B)`` result in
  ``Executor.decode``, carries the pragma.
* ``injected-fault-raise`` — raising the fault harness's exception types
  outside ``src/repro_torch/core/faults.py``, the allowlist's one entry.
* ``deprecated-*`` — the reference's retired names, over the port's
  files, with an allowlist of the port files that define or mention them.

Rules of the reference that this lint does not register:

* ``donate-without-out-shardings`` — the port has no ``jit`` and no
  donation: a step writes its cache in place, and whether it did is
  checked at run time by the transfer audit's storage check
  (:mod:`repro_torch.analysis.transfer_audit`, ``missed-donation``), at
  every ``Executor`` build.  A rule that can never fire is not kept.
* ``cross-pool-device-put`` — it guards the disaggregated pools' bridge,
  which waits for ROADMAP A13 (pools).

Trigger strings of the reference's pattern rules, which lint this file
too, are assembled at import, never written out.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Iterable, Iterator

__all__ = [
    "LintViolation",
    "Rule",
    "PatternRule",
    "register",
    "registered_rules",
    "get_rule",
    "lint_source",
    "lint_file",
    "lint_repo",
    "port_files",
    "SCAN_DIRS",
]

#: the port's files: a directory is scanned for ``*.py``, anything else is
#: a glob from the repo root
SCAN_DIRS = ("src/repro_torch", "tests/test_torch_*.py", "chip_smoke.py")

_PRAGMA_RE = re.compile(r"#\s*repro:\s*lint-disable=([\w\-,\s]+)")


@dataclasses.dataclass(frozen=True)
class LintViolation:
    rule: str
    path: str          # repo-relative posix path ("<string>" for lint_source)
    line: int
    message: str
    severity: str = "error"
    snippet: str = ""

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """One lint rule.  Subclasses implement :meth:`check`."""

    name: str = ""
    description: str = ""
    severity: str = "error"
    #: repo-relative paths exempt from this rule
    allow: frozenset[str] = frozenset()
    #: if set, only paths matching this regex are checked
    path_filter: re.Pattern | None = None

    def applies(self, relpath: str) -> bool:
        if relpath in self.allow:
            return False
        if self.path_filter is not None and not self.path_filter.search(relpath):
            return False
        return True

    def check(self, relpath: str, source: str, tree: ast.AST | None
              ) -> Iterable[LintViolation]:
        raise NotImplementedError

    def _violation(self, relpath: str, line: int, message: str,
                   snippet: str = "") -> LintViolation:
        return LintViolation(rule=self.name, path=relpath, line=line, message=message,
                             severity=self.severity, snippet=snippet)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_RULES: dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if not rule.name:
        raise ValueError("rule needs a name")
    if rule.name in _RULES:
        raise ValueError(f"duplicate lint rule {rule.name!r}")
    _RULES[rule.name] = rule
    return rule


def registered_rules() -> dict[str, Rule]:
    return dict(_RULES)


def get_rule(name: str) -> Rule:
    return _RULES[name]


# ---------------------------------------------------------------------------
# Pragmas and the entry points
# ---------------------------------------------------------------------------

def _parse_pragmas(source: str) -> tuple[set[str], dict[int, set[str]]]:
    """(file-level disabled rules, line -> disabled rules)."""
    file_level: set[str] = set()
    per_line: dict[int, set[str]] = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
        if line.strip().startswith("#"):
            file_level |= rules
        else:
            per_line.setdefault(lineno, set()).update(rules)
    return file_level, per_line


def lint_source(source: str, relpath: str = "<string>",
                rules: Iterable[Rule] | None = None) -> list[LintViolation]:
    """Lint one source blob; pragma- and allowlist-filtered."""
    active = list(rules) if rules is not None else list(_RULES.values())
    file_off, line_off = _parse_pragmas(source)
    try:
        tree: ast.AST | None = ast.parse(source)
    except SyntaxError:
        tree = None
    out: list[LintViolation] = []
    for rule in active:
        if not rule.applies(relpath) or rule.name in file_off:
            continue
        for v in rule.check(relpath, source, tree):
            if rule.name not in line_off.get(v.line, ()):
                out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.rule))
    return out


def lint_file(path: pathlib.Path, root: pathlib.Path,
              rules: Iterable[Rule] | None = None) -> list[LintViolation]:
    rel = path.resolve().relative_to(root.resolve()).as_posix()
    return lint_source(path.read_text(), rel, rules)


def port_files(root: pathlib.Path, dirs: Iterable[str] = SCAN_DIRS) -> list[pathlib.Path]:
    """The files :func:`lint_repo` scans, sorted, each once."""
    found: set[pathlib.Path] = set()
    for entry in dirs:
        base = root / entry
        if base.is_dir():
            found.update(base.rglob("*.py"))
        else:
            found.update(p for p in root.glob(entry) if p.is_file())
    return sorted(found)


def lint_repo(root: pathlib.Path, dirs: Iterable[str] = SCAN_DIRS,
              rules: Iterable[Rule] | None = None) -> list[LintViolation]:
    out: list[LintViolation] = []
    for path in port_files(root, dirs):
        out.extend(lint_file(path, root, rules))
    return out


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _call_name(node: ast.Call) -> str:
    """Dotted name of a call target (``torch.from_numpy`` / ``x.item``)."""
    f = node.func
    parts: list[str] = []
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def _store_key(target: ast.expr) -> str | None:
    """Key of the buffer a subscript/attribute mutation writes into:
    ``self.x[i] = v`` -> ``self.x``; ``toks[i] = v`` -> ``toks``."""
    t = target
    while isinstance(t, ast.Subscript):
        t = t.value
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) \
            and t.value.id == "self":
        return f"self.{t.attr}"
    if isinstance(t, ast.Name):
        return t.id
    return None


def _walk_functions(cls: ast.ClassDef) -> Iterator[ast.FunctionDef]:
    """Every function in the class, nested closures included."""
    for node in ast.walk(cls):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _own_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """``fn``'s body without nested function/lambda subtrees, so a
    closure's locals are not conflated with the enclosing scope's."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


# ---------------------------------------------------------------------------
# Rule: mutated-host-mirror-alias
# ---------------------------------------------------------------------------

#: constructors whose result shares the argument's memory
_ALIAS_CTORS = {"torch.from_numpy", "torch.as_tensor", "np.asarray", "numpy.asarray"}


class MutatedHostMirrorAlias(Rule):
    """A zero-copy view of a host buffer the same class mutates.

    ``torch.from_numpy(buf)`` shares ``buf``'s memory, and so do
    ``torch.as_tensor`` of an array of the same dtype and ``np.asarray``
    of a CPU tensor; mutating ``buf`` afterwards changes data a step was
    already handed.  A ``self`` attribute is flagged on a mutation
    anywhere in the class (the order of method calls is not known
    statically); a local name only when it is mutated after the view in
    the same function.
    """

    name = "mutated-host-mirror-alias"
    description = ("torch.from_numpy/torch.as_tensor/np.asarray zero-copy view of a "
                   "buffer that is later mutated in the same class")

    def check(self, relpath, source, tree):
        if tree is None:
            return
        for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
            aliases: list[tuple[str, int, str]] = []
            mutations: dict[str, list[tuple[int, str]]] = {}
            for fn in _walk_functions(cls):
                for node in _own_nodes(fn):
                    if isinstance(node, ast.Call) and node.args \
                            and _call_name(node) in _ALIAS_CTORS:
                        key = _store_key(node.args[0])
                        if key is not None and not isinstance(node.args[0], ast.Subscript):
                            aliases.append((key, node.lineno, fn.name))
                    targets: list[ast.expr] = []
                    if isinstance(node, ast.Assign):
                        targets = [t for t in node.targets if isinstance(t, ast.Subscript)]
                    elif isinstance(node, ast.AugAssign) and isinstance(
                            node.target, (ast.Subscript, ast.Attribute)):
                        targets = [node.target]
                    for t in targets:
                        key = _store_key(t)
                        if key is not None:
                            mutations.setdefault(key, []).append((node.lineno, fn.name))
            for key, lineno, fname in aliases:
                muts = mutations.get(key, [])
                hits = muts if key.startswith("self.") else [
                    (ln, f) for ln, f in muts if f == fname and ln > lineno]
                if hits:
                    mln, mfn = hits[0]
                    yield self._violation(
                        relpath, lineno,
                        f"zero-copy view of {key!r} shares host memory mutated at line "
                        f"{mln} (in {mfn}); copy explicitly or mutate before "
                        "constructing the view")


# ---------------------------------------------------------------------------
# Rule: blocking-transfer-in-hot-path
# ---------------------------------------------------------------------------

#: method calls that wait for the card when their receiver lies there
_BLOCKING_METHODS = {"item", "cpu", "tolist", "numpy"}
#: scalar casts, which wait for the card when fed a card tensor
_CAST_CALLS = {"float", "int"}
#: a hot function is named (or suffixed) step/decode; set-up functions such as
#: _build_steps are not on the per-token path
_HOT_FN_RE = re.compile(r"(?:^|_)(?:step|decode)$")


class BlockingTransferInHotPath(Rule):
    """A synchronous fetch or device-wide wait on the serve per-token path.

    Each ``.item()``, ``.cpu()``, ``.tolist()`` or ``.numpy()`` of a card
    tensor, each ``float()`` / ``int()`` of one, and each
    ``torch.cuda.synchronize()`` or ``<stream>.synchronize()``, inside a
    step/decode function of ``src/repro_torch/serve/`` stalls the host on
    the card once per token.  The casts are the reference's: an AST cannot
    tell a host integer from a card scalar, and the serve path's step
    functions cast none, so every cast there is flagged.  The one
    sanctioned fetch, the packed ``(2, B)`` result in ``Executor.decode``,
    carries the pragma.  What the AST cannot see (a sync inside a helper
    a step calls) the transfer audit sees at run time, as a D2H copy
    record over the allowance.
    """

    name = "blocking-transfer-in-hot-path"
    description = (".item()/.cpu()/.tolist()/.numpy()/float()/int()/synchronize() "
                   "inside serve step/decode code")
    path_filter = re.compile(r"^src/repro_torch/serve/")

    def check(self, relpath, source, tree):
        if tree is None:
            return
        fns = [n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
               and _HOT_FN_RE.search(n.name)]
        for fn in fns:
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                cname = _call_name(node)
                attr = (node.func.attr if isinstance(node.func, ast.Attribute) else "")
                hit = None
                if attr in _BLOCKING_METHODS:
                    hit = f".{attr}()"
                elif attr == "synchronize":
                    hit = f"{cname or '<stream>.synchronize'}()"
                elif cname in _CAST_CALLS and node.args:
                    hit = f"{cname}()"
                if hit:
                    yield self._violation(
                        relpath, node.lineno,
                        f"{hit} in {fn.name}() waits for the card on the per-token "
                        "path; batch the fetch or keep it on the device")


# ---------------------------------------------------------------------------
# Pattern rules
# ---------------------------------------------------------------------------

class PatternRule(Rule):
    """A regex over the source (comment text stripped per line)."""

    def __init__(self, name: str, pattern: str, message: str,
                 allow: Iterable[str] = (), path_filter: str | None = None):
        self.name = name
        self.description = message
        self.pattern = re.compile(pattern)
        self.message = message
        self.allow = frozenset(allow)
        if path_filter is not None:
            self.path_filter = re.compile(path_filter)

    def check(self, relpath, source, tree):
        for lineno, line in enumerate(source.splitlines(), start=1):
            code = line.split("#", 1)[0]
            if self.pattern.search(code):
                yield self._violation(relpath, lineno, self.message, snippet=line.strip())


# the retired names, assembled so that no lint finds them in this file
_POLICIES = "POLI" + "CIES"
_POLICY_SPECS = "policy" + "_specs"
_PUT_LIKE = "put" + "_like"
_DEFAULT_SYSTEM = "DEFAULT" + "_SYSTEM"
_STATS = ".st" + "ats"

#: the port files that mention a retired name: the modules importing
#: ``Executor`` from the engine module, and docstrings naming its classes
_DEPRECATION_ALLOW = frozenset({
    "src/repro_torch/serve/__init__.py",
    "src/repro_torch/serve/scheduler.py",
    "src/repro_torch/core/faults.py",
    "src/repro_torch/models/transformer.py",
    "src/repro_torch/examples/placement_sweep.py",
    "tests/test_torch_cuda.py",
    "tests/test_torch_robustness.py",
    "chip_smoke.py",
})

#: the fault harness's exception types
_FAULT_TYPES = ("InjectedFault", "TransientFault", "TierLossError", "MigrationFault",
                "SpillCorruptionError", "TicketLossError")

register(MutatedHostMirrorAlias())
register(BlockingTransferInHotPath())
register(PatternRule(
    "deprecated-policies", rf"\b{_POLICIES}\b",
    f"{_POLICIES} is deprecated: use registered_policies()/get_policy()/parse_policy()",
    _DEPRECATION_ALLOW,
))
register(PatternRule(
    "deprecated-policy-specs", rf"\b{_POLICY_SPECS}\b",
    f"{_POLICY_SPECS} is deprecated: use Runtime.realize", _DEPRECATION_ALLOW,
))
register(PatternRule(
    "deprecated-put-like", rf"\b{_PUT_LIKE}\b",
    f"{_PUT_LIKE} is deprecated: use Runtime.realize", _DEPRECATION_ALLOW,
))
register(PatternRule(
    "deprecated-engine-import",
    r"(from\s+repro_torch\.serve\.engine\s+import"
    r"|import\s+repro_torch\.serve\.engine"
    r"|\brepro_torch\.serve\.engine\.)",
    "import the repro_torch.serve package, not the engine module (Executor-only; "
    "Request/ServeConfig/Server live in the scheduler layer)",
    _DEPRECATION_ALLOW,
))
register(PatternRule(
    "deprecated-stats-dict", re.escape(_STATS + "["),
    f"Server{_STATS} is a method: call {_STATS}(), not {_STATS}[...]",
    _DEPRECATION_ALLOW,
))
register(PatternRule(
    "deprecated-default-system", rf"\b{_DEFAULT_SYSTEM}\b",
    f"{_DEFAULT_SYSTEM} is retired: price through Runtime / get_active_system() so a "
    "calibration re-prices everything (SPEC_SYSTEM for explicit comparisons)",
    _DEPRECATION_ALLOW,
))
register(PatternRule(
    "injected-fault-raise",
    r"\braise\s+(?:faults\.)?(?:" + "|".join(_FAULT_TYPES) + r")\b",
    "injected fault types may only be raised by the harness (core/faults.py): "
    "production code must signal failures with its own error types, never "
    "impersonate an injected fault",
    frozenset({"src/repro_torch/core/faults.py"}),
))
