"""Rule: no bare ``assert`` enforcing validation/privacy in library code.

``assert`` statements are stripped under ``python -O`` — an invariant that
matters (shape checks, fitted-state checks, privacy preconditions) must
``raise`` so it survives optimization.  Demo entry points under
``launch/`` are exempt by policy: CI executes them unoptimized and their
asserts *are* the integration gate.
"""
from __future__ import annotations

import ast

from ..base import Finding, ModuleSource, module_matches
from ..policy import DEFAULT_POLICY, Policy


def _qualname_map(tree) -> dict[int, str]:
    """Map each statement line to its enclosing def/class qualname."""
    spans: list[tuple[int, int, str]] = []

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                q = prefix + child.name
                spans.append((child.lineno, child.end_lineno or child.lineno,
                              q))
                walk(child, q + ".")
            else:
                walk(child, prefix)

    walk(tree, "")
    out = {}
    for lo, hi, q in sorted(spans, key=lambda s: s[1] - s[0], reverse=True):
        for line in range(lo, hi + 1):
            out[line] = q       # innermost (smallest) span wins
    return out


def run(modules: list[ModuleSource],
        policy: Policy = DEFAULT_POLICY) -> list[Finding]:
    findings = []
    for m in modules:
        if module_matches(m, policy.assert_exempt_globs):
            continue
        quals = _qualname_map(m.tree)
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Assert):
                try:
                    test = ast.unparse(node.test)[:60]
                except Exception:
                    test = "<condition>"
                findings.append(Finding(
                    rule="asserts", path=m.rel, line=node.lineno,
                    symbol=quals.get(node.lineno, "<module>"),
                    message=f"bare `assert {test}` dies under `python -O` — "
                            f"raise ValueError/TypeError instead"))
    return findings
