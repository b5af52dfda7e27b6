"""The port's privacy-egress linter against the JAX package's.

Every fixture of tests/analysis_fixtures/ goes through both packages'
``run_analysis``, rule by rule (and the ``locks`` rule with its replaced
policy): the findings are equal in rule, path, symbol, line and message.
The port's own tree is finding-free with its empty baseline, its
``# egress: ok(...)`` suppressions are exactly the JAX package's three,
each provisioning one inside an ``allow_egress`` block, the ``asserts``
rule exempts the port's ``launch/`` (and only because of the policy), and
the two CLIs give the same JSON reports and exit codes.
"""
import ast
import dataclasses
import json
from pathlib import Path

import pytest

from repro.analysis import run_analysis as j_run_analysis
from repro.analysis.__main__ import main as j_cli_main
from repro.analysis.base import load_modules as j_load_modules
from repro.analysis.base import suppressed_lines as j_suppressed_lines
from repro.analysis.policy import DEFAULT_POLICY as J_POLICY
from repro_torch.analysis import ALL_RULES, run_analysis
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.base import load_modules, suppressed_lines
from repro_torch.analysis.policy import DEFAULT_POLICY

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "analysis_fixtures"
SRC_PORT = ROOT / "src" / "repro_torch"
SRC_JAX = ROOT / "src" / "repro"
FIXTURE_FILES = sorted(p.name for p in FIXTURES.glob("*.py"))
# (fixture, rule) pairs whose findings must not be empty: parity between
# two empty lists would prove nothing about the port's pass
NON_EMPTY = {("leak_direct.py", "egress"), ("leak_helper.py", "egress"),
             ("leak_partial.py", "egress"), ("leak_smuggle.py", "egress"),
             ("fix_rules.py", "asserts"), ("fix_rules.py", "determinism"),
             ("fix_rules.py", "locks-policy")} | {
    # its empty-reason suppression is reported whatever the rule
    ("suppressed.py", r) for r in (*ALL_RULES, "locks-policy")}


def _key(findings):
    return [(f.rule, f.path, f.symbol, f.line, f.message) for f in findings]


@pytest.mark.parametrize("rule", [*ALL_RULES, "locks-policy"])
@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_fixture_findings_equal_jax(fixture, rule):
    path = FIXTURES / fixture
    if rule == "locks-policy":      # tests/test_analysis.py's locks case
        port = run_analysis([path], rules=("locks",), policy=dataclasses.
                            replace(DEFAULT_POLICY, lock_modules=(fixture,)))
        ref = j_run_analysis([path], rules=("locks",), policy=dataclasses.
                             replace(J_POLICY, lock_modules=(fixture,)))
    else:
        port = run_analysis([path], rules=(rule,))
        ref = j_run_analysis([path], rules=(rule,))
    assert _key(port) == _key(ref)
    assert bool(port) == ((fixture, rule) in NON_EMPTY)


def test_policy_sets_equal_jax():
    assert dataclasses.asdict(DEFAULT_POLICY) == dataclasses.asdict(J_POLICY)


def test_port_tree_is_finding_free():
    """The acceptance gate: src/repro_torch passes every rule with no
    findings, with the checked-in baseline empty."""
    assert run_analysis([SRC_PORT]) == []
    baseline = SRC_PORT / "analysis" / "baseline.json"
    assert json.loads(baseline.read_text()) == []


def test_chip_smoke_is_finding_free():
    assert run_analysis([ROOT / "chip_smoke.py"]) == []


def _suppressions(load, lines, src, policy):
    return {(m.rel, reason): (m, line)
            for m in load([src], exclude_globs=policy.exclude_globs)
            for line, reason in lines(m.text).items()}


def _inside_allow_egress(mod, line) -> bool:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.With) \
                and node.lineno < line <= node.end_lineno \
                and any(isinstance(i.context_expr, ast.Call)
                        and getattr(i.context_expr.func, "attr", None)
                        == "allow_egress" for i in node.items):
            return True
    return False


def test_suppressions_are_the_jax_packages_three():
    port = _suppressions(load_modules, suppressed_lines, SRC_PORT,
                         DEFAULT_POLICY)
    ref = _suppressions(j_load_modules, j_suppressed_lines, SRC_JAX,
                        J_POLICY)
    assert set(port) == set(ref)
    assert sorted(rel for rel, _ in port) == [
        "federation/distributed.py", "federation/distributed.py",
        "federation/party_worker.py"]
    for (rel, reason), (mod, line) in port.items():
        # a provisioning send is allowed at run time too; the labels'
        # send stays guarded (its labels are a fancy-index copy)
        assert _inside_allow_egress(mod, line) == reason.startswith(
            "provisioning"), (rel, line)


def test_asserts_rule_exempts_the_ports_launch_demos():
    launch = SRC_PORT / "launch"
    assert run_analysis([launch], rules=("asserts",)) == []
    unexempt = dataclasses.replace(DEFAULT_POLICY, assert_exempt_globs=())
    assert run_analysis([launch], rules=("asserts",), policy=unexempt)


def _cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_json_and_exit_codes_equal_jax(tmp_path, capsys):
    leak = str(FIXTURES / "leak_direct.py")
    argv = [leak, "--json", "--fail-on-findings", "--no-baseline"]
    rc, out = _cli(cli_main, argv, capsys)
    j_rc, j_out = _cli(j_cli_main, argv, capsys)
    assert (rc, json.loads(out)) == (j_rc, json.loads(j_out))
    assert rc == 1 and json.loads(out)["findings"][0]["rule"] == "egress"

    # baseline the findings, then the same run passes
    for main, name in ((cli_main, "port"), (j_cli_main, "jax")):
        baseline = tmp_path / f"{name}.json"
        assert _cli(main, [leak, "--write-baseline", str(baseline)],
                    capsys)[0] == 0
        rc, out = _cli(main, [leak, "--fail-on-findings", "--baseline",
                              str(baseline)], capsys)
        assert rc == 0 and "1 baselined" in out
    assert (tmp_path / "port.json").read_text() \
        == (tmp_path / "jax.json").read_text()

    # the port's tree passes clean with its checked-in (empty) baseline
    assert _cli(cli_main, [str(SRC_PORT), "--fail-on-findings"],
                capsys)[0] == 0
    # a usage error exits 2 in both
    for main in (cli_main, j_cli_main):
        with pytest.raises(SystemExit) as ei:
            main([leak, "--rules", "nope"])
        assert ei.value.code == 2
    capsys.readouterr()
