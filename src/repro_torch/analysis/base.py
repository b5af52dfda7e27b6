"""Shared plumbing for the analysis passes: findings, files, suppressions.

Every rule pass (egress taint linter, asserts, determinism, locks) produces
:class:`Finding` records over a set of Python files; this module owns the
record type, the file iteration (with policy path excludes), and the
``# egress: ok(reason)`` suppression contract:

  * a finding anchored at line L is suppressed when line L — or the line
    directly above it — carries ``# egress: ok(<non-empty reason>)``;
  * an ``# egress: ok()`` with an EMPTY reason suppresses nothing and is
    itself reported (rule ``suppression``): a silenced warning without a
    written-down justification is how invariants rot.

Baselines: a JSON list of finding fingerprints (rule/path/symbol/message —
deliberately line-number-free so unrelated edits don't invalidate it) that
are tolerated; the CLI's ``--baseline`` filter lets a new rule land without
blocking on pre-existing findings while keeping them visible via
``--no-baseline``.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import re
from pathlib import Path

SUPPRESS_RE = re.compile(r"#\s*egress:\s*ok\(([^)]*)\)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analysis finding, anchored to a file/line/function."""

    rule: str          # "egress" | "asserts" | "determinism" | "locks" | ...
    path: str          # path relative to the analysis root
    line: int
    symbol: str        # qualname of the enclosing def/class, or "<module>"
    message: str

    def fingerprint(self) -> dict:
        """Line-number-free identity used by baseline files."""
        return {"rule": self.rule, "path": self.path,
                "symbol": self.symbol, "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.symbol}: " \
               f"{self.message}"


@dataclasses.dataclass
class ModuleSource:
    """One parsed module handed to the rule passes."""

    path: Path          # absolute
    rel: str            # path relative to the analysis root (policy matching)
    text: str
    tree: "object"      # ast.Module

    def lines(self) -> list[str]:
        return self.text.splitlines()


def iter_py_files(roots, exclude_globs=()) -> list[tuple[Path, str]]:
    """All .py files under ``roots`` (files pass through), as
    ``(absolute, root-relative)`` pairs, minus policy-excluded globs."""
    out = []
    for root in roots:
        root = Path(root).resolve()
        if root.is_file():
            files = [(root, root.name)]
        else:
            files = sorted((p, p.relative_to(root).as_posix())
                           for p in root.rglob("*.py"))
        for abs_path, rel in files:
            if any(fnmatch.fnmatch(rel, g) for g in exclude_globs):
                continue
            out.append((abs_path, rel))
    return out


def load_modules(roots, exclude_globs=()) -> list[ModuleSource]:
    import ast
    mods = []
    for abs_path, rel in iter_py_files(roots, exclude_globs):
        text = abs_path.read_text()
        mods.append(ModuleSource(path=abs_path, rel=rel, text=text,
                                 tree=ast.parse(text, filename=str(abs_path))))
    return mods


def module_matches(mod: ModuleSource, patterns) -> bool:
    """Glob match against the root-relative path, falling back to the
    absolute path — so `launch/*` exempts launch demos whether the
    analyzer was pointed at src/repro_torch or at the launch dir itself."""
    apath = mod.path.as_posix()
    return any(fnmatch.fnmatch(mod.rel, g)
               or fnmatch.fnmatch(apath, "*/" + g)
               for g in patterns)


def suppressed_lines(text: str) -> dict[int, str]:
    """{1-based line: reason} for every ``# egress: ok(reason)`` comment."""
    out = {}
    for i, line in enumerate(text.splitlines(), start=1):
        m = SUPPRESS_RE.search(line)
        if m is not None:
            out[i] = m.group(1).strip()
    return out


def apply_suppressions(findings: list[Finding],
                       modules: list[ModuleSource]) -> list[Finding]:
    """Filter findings under valid suppression comments; report empty-reason
    suppressions as findings of their own."""
    supp = {m.rel: suppressed_lines(m.text) for m in modules}
    kept = []
    for f in findings:
        lines = supp.get(f.path, {})
        reason = lines.get(f.line)
        if reason is None:
            reason = lines.get(f.line - 1)
        if reason:          # non-empty reason suppresses
            continue
        kept.append(f)
    for m in modules:
        for line, reason in supp[m.rel].items():
            if not reason:
                kept.append(Finding(
                    rule="suppression", path=m.rel, line=line,
                    symbol="<module>",
                    message="egress suppression without a reason — write "
                            "the justification inside ok(...): an unexplained "
                            "silence is unauditable"))
    return sorted(kept, key=lambda f: (f.path, f.line, f.rule))


def load_baseline(path) -> list[dict]:
    p = Path(path)
    if not p.exists():
        return []
    data = json.loads(p.read_text() or "[]")
    if not isinstance(data, list):
        raise ValueError(f"{path}: baseline must be a JSON list of "
                         f"fingerprints")
    return data


def filter_baseline(findings: list[Finding], baseline: list[dict]):
    """Split findings into (new, baselined) against fingerprint entries."""
    known = {tuple(sorted(d.items())) for d in baseline}
    new, old = [], []
    for f in findings:
        (old if tuple(sorted(f.fingerprint().items())) in known
         else new).append(f)
    return new, old
