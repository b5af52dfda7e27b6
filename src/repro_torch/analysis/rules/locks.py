"""Rule: thread-shared fields are mutated only under their owning lock.

The field→lock map is NOT hardcoded here — it is parsed from each
threading class's docstring, which is the single authoritative source.
A class that owns a ``threading.Lock``/``RLock`` must carry a section of
the form::

    Lock discipline (checked by repro_torch.analysis rules/locks):
        _lock: _pending, _next_id, request_stats
        unsynchronized (coordinator thread only): dead_letters, ring

Grammar: a line containing ``Lock discipline`` opens the section; each
following ``<lock-attr>[ (note) ]: field, field, ...`` line assigns fields
to the lock attribute that must be held (via ``with self.<lock-attr>:``)
when they are mutated.  The special group ``unsynchronized`` documents
fields that are single-thread-by-contract (with the reason in the
parenthetical).  The section ends at the first non-matching line.

Checks, for every class in ``policy.lock_modules``:

  * a class that creates a lock in ``__init__`` but has no section → finding
    (undocumented discipline);
  * a mutation of ``self.<field>`` (assign/augassign/subscript-store/del/
    in-place mutator call) outside ``__init__`` where the field is mapped
    to a lock but the mutation is not lexically inside
    ``with self.<lock>:`` → finding;
  * a mutation of a ``self.<field>`` not covered by any group → finding
    (the map must stay exhaustive or it rots).

Nested ``def``s reset the held-lock context: a closure's body runs later,
on some other thread's schedule, even if it is *defined* under the lock.
"""
from __future__ import annotations

import ast
import re

from ..base import Finding, ModuleSource, module_matches
from ..policy import DEFAULT_POLICY, Policy

_SECTION_RE = re.compile(r"Lock discipline")
_GROUP_RE = re.compile(r"^\s*(\w+)\s*(?:\([^)]*\))?\s*:\s*(.+?)\s*$")


def parse_lock_map(docstring: str | None):
    """-> {field: lock_attr | None}  (None = documented unsynchronized),
    or None when the docstring has no Lock discipline section."""
    if not docstring:
        return None
    lines = docstring.splitlines()
    start = None
    for i, line in enumerate(lines):
        if _SECTION_RE.search(line):
            start = i + 1
            break
    if start is None:
        return None
    field_map: dict[str, str | None] = {}
    for line in lines[start:]:
        if not line.strip():
            if field_map:
                break
            continue
        m = _GROUP_RE.match(line)
        if m is None:
            break
        lock, fields = m.group(1), m.group(2)
        owner = None if lock == "unsynchronized" else lock
        for f in fields.split(","):
            f = f.strip()
            if f:
                field_map[f] = owner
    return field_map


def _self_field(node):
    """The `f` in self.f / self.f[...] / self.f[...].g chains (outermost
    attribute hanging off `self`), else None."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        node = node.value
    return None


def _creates_lock(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("Lock", "RLock")):
            return True
    return False


class _MutationScanner:
    def __init__(self, policy, findings, rel, cls_name, field_map):
        self.policy = policy
        self.findings = findings
        self.rel = rel
        self.cls_name = cls_name
        self.field_map = field_map

    def _flag(self, node, method, field, lock):
        if lock is _UNDECLARED:
            msg = (f"mutation of `self.{field}` not covered by the class "
                   f"docstring's Lock discipline map — declare its owning "
                   f"lock or document it as unsynchronized")
        else:
            msg = (f"`self.{field}` is owned by `self.{lock}` per the class "
                   f"docstring but is mutated outside `with self.{lock}:`")
        self.findings.append(Finding(
            rule="locks", path=self.rel, line=node.lineno,
            symbol=f"{self.cls_name}.{method}", message=msg))

    def _check(self, node, method, field, held):
        if field is None:
            return
        if field not in self.field_map:
            self._flag(node, method, field, _UNDECLARED)
            return
        lock = self.field_map[field]
        if lock is not None and lock not in held:
            self._flag(node, method, field, lock)

    def _scan_expr(self, expr, method_name, held):
        """Mutator calls (self.f.append(...) etc.) inside one expression."""
        if expr is None:
            return
        for node in ast.walk(expr):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self.policy.mutator_methods):
                self._check(node, method_name,
                            _self_field(node.func.value), held)

    def scan_method(self, method: ast.FunctionDef):
        if method.name == "__init__":
            return
        name = method.name

        def walk(stmts, held):
            for stmt in stmts:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    walk(stmt.body, frozenset())   # closures run unlocked
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    inner = set(held)
                    for item in stmt.items:
                        self._scan_expr(item.context_expr, name, held)
                        ctx = item.context_expr
                        if (isinstance(ctx, ast.Attribute)
                                and isinstance(ctx.value, ast.Name)
                                and ctx.value.id == "self"):
                            inner.add(ctx.attr)
                    walk(stmt.body, frozenset(inner))
                elif isinstance(stmt, (ast.If, ast.While)):
                    self._scan_expr(stmt.test, name, held)
                    walk(stmt.body, held)
                    walk(stmt.orelse, held)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    self._scan_expr(stmt.iter, name, held)
                    self._check(stmt.target, name,
                                _self_field(stmt.target), held)
                    walk(stmt.body, held)
                    walk(stmt.orelse, held)
                elif isinstance(stmt, ast.Try):
                    walk(stmt.body, held)
                    for handler in stmt.handlers:
                        walk(handler.body, held)
                    walk(stmt.orelse, held)
                    walk(stmt.finalbody, held)
                else:
                    # simple statement: no nested statements inside, safe
                    # to scan the whole subtree with the current held set
                    if isinstance(stmt, (ast.Assign, ast.AnnAssign,
                                         ast.AugAssign)):
                        targets = (stmt.targets
                                   if isinstance(stmt, ast.Assign)
                                   else [stmt.target])
                        for t in targets:
                            self._check(t, name, _self_field(t), held)
                    elif isinstance(stmt, ast.Delete):
                        for t in stmt.targets:
                            self._check(t, name, _self_field(t), held)
                    for child in ast.iter_child_nodes(stmt):
                        if isinstance(child, ast.expr):
                            self._scan_expr(child, name, held)

        walk(method.body, frozenset())


_UNDECLARED = object()


def run(modules: list[ModuleSource],
        policy: Policy = DEFAULT_POLICY) -> list[Finding]:
    findings = []
    for m in modules:
        if not module_matches(m, policy.lock_modules):
            continue
        for node in ast.walk(m.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            field_map = parse_lock_map(ast.get_docstring(node))
            if field_map is None:
                if _creates_lock(node):
                    findings.append(Finding(
                        rule="locks", path=m.rel, line=node.lineno,
                        symbol=node.name,
                        message=f"class `{node.name}` owns a threading lock "
                                f"but its docstring has no 'Lock "
                                f"discipline' field→lock map"))
                continue
            scanner = _MutationScanner(policy, findings, m.rel,
                                       node.name, field_map)
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    scanner.scan_method(item)
    return findings
