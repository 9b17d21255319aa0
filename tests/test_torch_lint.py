"""The port's lint (``repro_torch.analysis.lint``), mirroring
``tests/test_analysis_lint.py``: the registry, each rule on its fixture
and a pragma that silences it, allowlists, and the port's own files clean.

Trigger strings of the pattern rules and the pragmas are assembled at run
time, so this file trips neither the port's lint nor the reference's
(which lints ``tests/`` too).
"""

import ast
import pathlib
import textwrap

import pytest

from repro_torch.analysis import lint

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _src(body: str) -> str:
    return textwrap.dedent(body)


def _pragma(*rules: str) -> str:
    return "  # repro: " + "lint-disable=" + ",".join(rules)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class TestRegistry:
    def test_expected_rules_registered(self):
        assert set(lint.registered_rules()) == {
            "mutated-host-mirror-alias",
            "blocking-transfer-in-hot-path",
            "deprecated-policies",
            "deprecated-policy-specs",
            "deprecated-put-like",
            "deprecated-engine-import",
            "deprecated-stats-dict",
            "deprecated-default-system",
            "injected-fault-raise",
        }

    def test_rules_that_cannot_fire_are_not_registered(self):
        # no jit, no donation (the audit's storage check replaces it); the
        # pools' bridge waits for ROADMAP A13
        names = set(lint.registered_rules())
        assert "donate-without-out-shardings" not in names
        assert "cross-pool-device-put" not in names
        doc = lint.__doc__
        assert "missed-donation" in doc and "A13" in doc

    def test_duplicate_registration_rejected(self):
        lint.register(lint.PatternRule("dup-test-rule", r"zzz", "no"))
        try:
            with pytest.raises(ValueError, match="duplicate"):
                lint.register(lint.PatternRule("dup-test-rule", r"zzz", "no"))
        finally:
            del lint._RULES["dup-test-rule"]

    def test_nameless_rule_rejected(self):
        with pytest.raises(ValueError, match="name"):
            lint.register(lint.Rule())

    def test_get_rule(self):
        assert lint.get_rule("deprecated-policies").name == "deprecated-policies"


# ---------------------------------------------------------------------------
# mutated-host-mirror-alias
# ---------------------------------------------------------------------------

RULE_MIRROR = [lint.get_rule("mutated-host-mirror-alias")]


class TestMutatedHostMirrorAlias:
    @pytest.mark.parametrize("ctor", ["torch.from_numpy", "torch.as_tensor", "np.asarray"])
    def test_self_attr_any_order(self, ctor):
        src = _src(f"""
            class Loop:
                def poke(self):
                    self.buf[0] = 1

                def view(self):
                    return {ctor}(self.buf)
        """)
        (v,) = lint.lint_source(src, "x.py", rules=RULE_MIRROR)
        assert "self.buf" in v.message and v.line == 7

    def test_local_mutated_after_alias(self):
        src = _src("""
            class A:
                def f(self):
                    toks = np.zeros(4)
                    t = torch.from_numpy(toks)
                    toks[0] = 1
                    return t
        """)
        assert len(lint.lint_source(src, "x.py", rules=RULE_MIRROR)) == 1

    def test_local_mutated_before_alias_is_fine(self):
        src = _src("""
            class A:
                def f(self):
                    toks = np.zeros(4)
                    toks[0] = 1
                    return torch.from_numpy(toks)
        """)
        assert lint.lint_source(src, "x.py", rules=RULE_MIRROR) == []

    def test_nested_closure_scoped_separately(self):
        src = _src("""
            class A:
                def f(self):
                    toks = np.zeros(4)
                    t = torch.from_numpy(toks)

                    def g():
                        toks = np.ones(4)
                        toks[0] = 2
                        return toks
                    return t, g
        """)
        assert lint.lint_source(src, "x.py", rules=RULE_MIRROR) == []

    def test_fresh_copy_subscript_arg_is_fine(self):
        src = _src("""
            class A:
                def f(self):
                    return torch.from_numpy(self.buf[:2])

                def g(self):
                    self.buf[0] = 1
        """)
        assert lint.lint_source(src, "x.py", rules=RULE_MIRROR) == []


# ---------------------------------------------------------------------------
# blocking-transfer-in-hot-path
# ---------------------------------------------------------------------------

RULE_HOT = [lint.get_rule("blocking-transfer-in-hot-path")]

HOT_SRC = _src("""
    def decode(x):
        return x.cpu()

    def warmup(x):
        return x.cpu()

    def step(x):
        return x.count.item()
""")


class TestBlockingTransferInHotPath:
    def test_only_hot_functions_flagged(self):
        vs = lint.lint_source(HOT_SRC, "src/repro_torch/serve/zz.py", rules=RULE_HOT)
        assert len(vs) == 2  # decode() and step(); warmup() is cold

    def test_path_filter_is_the_ports_serve(self):
        assert len(lint.lint_source(HOT_SRC, "src/repro_torch/serve/engine.py",
                                    rules=RULE_HOT)) == 2
        # the reference's serve path is the reference lint's to check
        assert lint.lint_source(HOT_SRC, "src/repro/serve/engine.py", rules=RULE_HOT) == []
        assert lint.lint_source(HOT_SRC, "src/repro_torch/core/zz.py", rules=RULE_HOT) == []
        assert lint.lint_source(HOT_SRC, "tests/zz.py", rules=RULE_HOT) == []

    @pytest.mark.parametrize("call,hit", [
        ("x.item()", ".item()"), ("x.cpu()", ".cpu()"), ("x.tolist()", ".tolist()"),
        ("x.numpy()", ".numpy()"), ("torch.cuda.synchronize()", "synchronize"),
        ("torch.cuda.current_stream().synchronize()", "synchronize"),
        ("float(x[0])", "float()"), ("int(x.sum())", "int()"),
    ])
    def test_each_blocking_call_flagged(self, call, hit):
        src = _src(f"""
            def _decode_step(x):
                return {call}
        """)
        (v,) = lint.lint_source(src, "src/repro_torch/serve/zz.py", rules=RULE_HOT)
        assert hit in v.message and "_decode_step" in v.message

    def test_build_helpers_are_not_hot(self):
        src = _src("""
            def _build_steps(cfg):
                return int(cfg.prefill_chunk), cfg.x.item()
        """)
        assert lint.lint_source(src, "src/repro_torch/serve/zz.py", rules=RULE_HOT) == []

    def test_serve_step_functions_cast_no_host_integer(self):
        """The reference's casts are carried because no step/decode
        function of the port's serve path casts anything."""
        rule = RULE_HOT[0]
        for path in sorted((ROOT / "src" / "repro_torch" / "serve").glob("*.py")):
            tree = ast.parse(path.read_text())
            for fn in ast.walk(tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and lint._HOT_FN_RE.search(fn.name):
                    casts = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                             and lint._call_name(n) in lint._CAST_CALLS]
                    assert casts == [], (path.name, fn.name)
        assert rule.path_filter.pattern == r"^src/repro_torch/serve/"


# ---------------------------------------------------------------------------
# Pragmas, allowlists, lint_source
# ---------------------------------------------------------------------------

BAD_HOT = "def decode(x):\n    return x.item()"


class TestSuppression:
    def test_per_line_pragma(self):
        src = BAD_HOT + _pragma("blocking-transfer-in-hot-path") + "\n"
        assert lint.lint_source(src, "src/repro_torch/serve/x.py", rules=RULE_HOT) == []

    def test_file_level_pragma(self):
        src = _pragma("blocking-transfer-in-hot-path").strip() + "\n" + BAD_HOT + "\n"
        assert lint.lint_source(src, "src/repro_torch/serve/x.py", rules=RULE_HOT) == []

    def test_pragma_lists_multiple_rules(self):
        src = (BAD_HOT + _pragma("mutated-host-mirror-alias",
                                 "blocking-transfer-in-hot-path") + "\n")
        assert lint.lint_source(src, "src/repro_torch/serve/x.py",
                                rules=RULE_HOT + RULE_MIRROR) == []

    def test_pragma_for_other_rule_does_not_suppress(self):
        src = BAD_HOT + _pragma("mutated-host-mirror-alias") + "\n"
        assert len(lint.lint_source(src, "src/repro_torch/serve/x.py",
                                    rules=RULE_HOT)) == 1

    def test_allowlist(self):
        rule = lint.PatternRule("t-allow", r"forbidden_token_zz", "no",
                                allow=("src/repro_torch/ok.py",))
        src = "x = forbidden_token_zz\n"
        assert lint.lint_source(src, "src/repro_torch/ok.py", rules=[rule]) == []
        assert len(lint.lint_source(src, "src/repro_torch/bad.py", rules=[rule])) == 1


class TestPatternRules:
    def test_comment_text_not_matched(self):
        trigger = "POLI" + "CIES"
        rules = [lint.get_rule("deprecated-policies")]
        assert lint.lint_source(f"# {trigger} in a comment\n", "x.py", rules=rules) == []
        vs = lint.lint_source(f"y = {trigger}['kv_host']\n", "x.py", rules=rules)
        assert len(vs) == 1 and vs[0].snippet

    @pytest.mark.parametrize("name,trigger", [
        ("deprecated-policy-specs", "policy" + "_specs(x)"),
        ("deprecated-put-like", "put" + "_like(x)"),
        ("deprecated-stats-dict", "srv.st" + "ats['x']"),
        ("deprecated-default-system", "DEFAULT" + "_SYSTEM.chip"),
    ])
    def test_each_retired_name_fires(self, name, trigger):
        rules = [lint.get_rule(name)]
        assert len(lint.lint_source(f"y = {trigger}\n", "src/repro_torch/x.py",
                                    rules=rules)) == 1

    def test_engine_import_rule(self):
        rules = [lint.get_rule("deprecated-engine-import")]
        bad = "from repro_torch.serve." + "engine import Server\n"
        good = "from repro_torch.serve import Server\n"
        assert len(lint.lint_source(bad, "x.py", rules=rules)) == 1
        assert lint.lint_source(good, "x.py", rules=rules) == []

    def test_syntax_error_source_still_pattern_checked(self):
        rules = [lint.get_rule("deprecated-put-like")]
        src = "def broken(:\n    x = put_" + "like(1)\n"
        assert len(lint.lint_source(src, "x.py", rules=rules)) == 1

    def test_deprecation_allowlist_is_the_ports_own_files(self):
        allow = lint.get_rule("deprecated-policies").allow
        assert allow and all(p.startswith(("src/repro_torch/", "tests/test_torch_"))
                             or p == "chip_smoke.py" for p in allow)
        assert all((ROOT / p).is_file() for p in allow)


class TestInjectedFaultRaise:
    RULE = [lint.get_rule("injected-fault-raise")]
    SRC = "raise " + "Migration" + "Fault('copy')\n"

    def test_fires_outside_the_harness(self):
        assert len(lint.lint_source(self.SRC, "src/repro_torch/serve/x.py",
                                    rules=self.RULE)) == 1

    def test_allowlist_is_exactly_the_harness(self):
        assert self.RULE[0].allow == frozenset({"src/repro_torch/core/faults.py"})
        assert lint.lint_source(self.SRC, "src/repro_torch/core/faults.py",
                                rules=self.RULE) == []


# ---------------------------------------------------------------------------
# The port's own files
# ---------------------------------------------------------------------------

class TestPortIsClean:
    def test_scan_covers_the_ports_files_only(self):
        files = {p.relative_to(ROOT).as_posix() for p in lint.port_files(ROOT)}
        assert "chip_smoke.py" in files
        assert "src/repro_torch/serve/engine.py" in files
        assert "tests/test_torch_lint.py" in files
        assert not any(f.startswith("src/repro/") for f in files)
        assert not any(f.startswith("tests/") and not f.startswith("tests/test_torch_")
                       for f in files)

    def test_lint_repo_has_no_errors(self):
        violations = [v for v in lint.lint_repo(ROOT) if v.severity == "error"]
        assert violations == [], "\n".join(map(str, violations))

    def test_only_the_packed_fetch_carries_the_hot_path_pragma(self):
        """In ``src/repro_torch/serve/`` the blocking-fetch pragma sits only
        on the lines of the packed (2, B) fetch in ``Executor.decode``, and
        without it the rule flags exactly those lines."""
        marker = "lint-disable=" + "blocking-transfer-in-hot-path"
        carriers = {}
        for path in sorted((ROOT / "src" / "repro_torch" / "serve").glob("*.py")):
            lines = [i for i, line in enumerate(path.read_text().splitlines(), 1)
                     if marker in line]
            if lines:
                carriers[path.name] = lines
        assert list(carriers) == ["engine.py"]
        src = (ROOT / "src" / "repro_torch" / "serve" / "engine.py").read_text()
        tree = ast.parse(src)
        (decode,) = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                     and n.name == "decode"]
        assert all(decode.lineno <= i <= decode.end_lineno for i in carriers["engine.py"])
        bare = src.replace(_pragma("blocking-transfer-in-hot-path"), "")
        flagged = [v.line for v in lint.lint_source(bare, "src/repro_torch/serve/engine.py",
                                                    rules=RULE_HOT)]
        assert flagged == carriers["engine.py"]
