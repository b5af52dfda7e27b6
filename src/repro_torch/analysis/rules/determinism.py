"""Rule: protocol and sketch code must be deterministic and seedable.

Three checks:

  * legacy global-state numpy RNG (``np.random.rand`` & co.) and stdlib
    ``random.*`` calls are banned everywhere in ``src/repro_torch`` — all
    randomness flows through seeded ``np.random.default_rng(seed)``
    generators (bit-identity across substrates depends on it);
  * ``np.random.default_rng()`` called with NO seed argument is flagged —
    an unseeded generator pulls OS entropy and breaks resumability;
  * inside declared deterministic zones (sketch/compaction code, binning,
    the tree builder, and any function decorated ``@register_program`` —
    the distributed protocol bodies), wall-clock reads
    (``time.time``/``monotonic``/``perf_counter``, ``datetime.now``,
    ``uuid4``) are flagged: time-dependent control flow there would make
    reruns diverge between parties.
"""
from __future__ import annotations

import ast

from ..base import Finding, ModuleSource, module_matches
from ..policy import DEFAULT_POLICY, Policy
from .asserts import _qualname_map


def _attr_chain(node) -> list[str]:
    """['np', 'random', 'rand'] for np.random.rand; [] if not a pure
    name/attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return []


def _zone_functions(tree) -> list[tuple[int, int]]:
    """Line spans of functions decorated with register_program."""
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                chain = _attr_chain(target)
                if chain and chain[-1] == "register_program":
                    spans.append((node.lineno,
                                  node.end_lineno or node.lineno))
    return spans


def run(modules: list[ModuleSource],
        policy: Policy = DEFAULT_POLICY) -> list[Finding]:
    findings = []
    for m in modules:
        quals = _qualname_map(m.tree)
        whole_module_zone = module_matches(m, policy.determinism_zone_globs)
        zone_spans = _zone_functions(m.tree)

        def in_zone(line):
            return whole_module_zone or any(lo <= line <= hi
                                            for lo, hi in zone_spans)

        for node in ast.walk(m.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if not chain:
                continue
            line, sym = node.lineno, quals.get(node.lineno, "<module>")
            # legacy global-state RNG — banned everywhere
            if (len(chain) >= 3 and chain[-3] in ("np", "numpy")
                    and chain[-2] == "random"
                    and chain[-1] in policy.legacy_rng_fns):
                findings.append(Finding(
                    rule="determinism", path=m.rel, line=line, symbol=sym,
                    message=f"legacy global-state RNG "
                            f"`{'.'.join(chain)}` — use a seeded "
                            f"np.random.default_rng(seed) generator"))
            elif (len(chain) == 2 and chain[0] == "random"
                    and chain[1] in policy.legacy_rng_fns):
                findings.append(Finding(
                    rule="determinism", path=m.rel, line=line, symbol=sym,
                    message=f"stdlib global-state RNG `{'.'.join(chain)}` — "
                            f"use a seeded np.random.default_rng(seed)"))
            # unseeded default_rng() — OS entropy breaks resumability
            elif (chain[-1] == "default_rng" and not node.args
                    and not node.keywords):
                findings.append(Finding(
                    rule="determinism", path=m.rel, line=line, symbol=sym,
                    message="unseeded np.random.default_rng() pulls OS "
                            "entropy — pass an explicit seed"))
            # wall-clock reads inside deterministic zones
            elif chain[-1] in policy.time_calls and in_zone(line):
                findings.append(Finding(
                    rule="determinism", path=m.rel, line=line, symbol=sym,
                    message=f"time-dependent call `{'.'.join(chain)}` inside "
                            f"a deterministic protocol/sketch zone — reruns "
                            f"would diverge between parties"))
    return findings
