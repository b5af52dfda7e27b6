"""AST taint analysis: prove raw party data cannot reach a wire sink.

The pass walks every module (it PARSES files, it never imports them), seeds
taint at reads of SECRET attributes (``.x`` / ``.ids`` / ``.y`` — the raw
fields of `PartyBlock`, streaming `SourceScan`s and chunk blocks), and
propagates it through assignments, containers, f-strings, arithmetic and
calls.  A finding fires when a secret-labelled value arrives at a wire
sink (`send`/`sendall`/`pack`/`request`/`_send`/`exchange`) without having
passed a registered sanitizer from `policy.SANITIZERS`.

Interprocedural reach comes from lightweight function summaries: every
function is abstractly executed with opaque markers bound to its
parameters, recording

  * ``param_to_sink`` — parameter positions that flow to a wire sink
    inside the function (or transitively through callees resolved in the
    same module), so ``helper(ch, block.ids)`` is flagged at the *call
    site* when ``helper`` forwards its argument to ``ch.send``;
  * ``param_to_return`` / ``returns_secret`` — whether the return value
    carries argument taint or freshly-read secrets.

Summaries are iterated to a fixpoint (bounded), then a final pass emits
findings.  Known, accepted imprecision: object *field* states don't
persist across methods (``self.f = secret`` in one method is not seen by
another), and cross-module calls are matched by bare name only — sinks and
sanitizers are name-based by policy, which keeps the pass sound for the
wire verbs that exist in this repo.

Flow handling is path-insensitive but order-sensitive: branches of an
``if``/``try`` are analyzed from the same entry state and merged (taint
union), loop bodies run twice to stabilize loop-carried taint, and a
reassignment strongly updates a variable — so ``ids = hash_ids(ids)``
really does clean ``ids``.
"""
from __future__ import annotations

import ast

from .base import Finding, ModuleSource
from .policy import DEFAULT_POLICY, Policy

_PARAM = "@p"
_SECRET_DESC = {"x": "raw feature matrix", "ids": "raw sample IDs",
                "y": "raw labels"}


def _is_param(label: str) -> bool:
    return label.startswith(_PARAM)


def _fmt_labels(labels) -> str:
    return ", ".join(sorted(l for l in labels if not _is_param(l)))


class _FnSummary:
    __slots__ = ("param_to_sink", "param_to_return", "returns_secret")

    def __init__(self):
        self.param_to_sink: dict[int, str] = {}
        self.param_to_return: set[int] = set()
        self.returns_secret: set[str] = set()

    def state(self):
        return (len(self.param_to_sink), len(self.param_to_return),
                len(self.returns_secret))


class _FnInfo:
    __slots__ = ("qualname", "node", "params", "is_method")

    def __init__(self, qualname, node, is_method):
        self.qualname = qualname
        self.node = node
        a = node.args
        self.params = [p.arg for p in (a.posonlyargs + a.args)]
        self.is_method = is_method and self.params[:1] in (["self"], ["cls"])


def _collect_functions(tree) -> list[_FnInfo]:
    fns = []

    def walk(node, prefix, in_class):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.append(_FnInfo(prefix + child.name, child, in_class))
                walk(child, prefix + child.name + ".", False)
            elif isinstance(child, ast.ClassDef):
                walk(child, prefix + child.name + ".", True)
            else:
                walk(child, prefix, in_class)

    walk(tree, "", False)
    return fns


class _ModuleCtx:
    def __init__(self, mod: ModuleSource):
        self.mod = mod
        self.functions = _collect_functions(mod.tree)
        self.by_name: dict[str, list[_FnInfo]] = {}
        for fn in self.functions:
            self.by_name.setdefault(fn.node.name, []).append(fn)


class _Eval:
    """Abstract interpreter for one function (or the module body)."""

    def __init__(self, ctx: _ModuleCtx, policy: Policy,
                 summaries: dict, qualname: str, emit: bool,
                 findings: list[Finding] | None):
        self.ctx = ctx
        self.policy = policy
        self.summaries = summaries
        self.qualname = qualname
        self.emit = emit
        self.findings = findings
        self.summary = summaries[(ctx.mod.rel, qualname)]
        self._reported: set[tuple[int, str]] = set()

    # -- helpers -------------------------------------------------------------

    def _finding(self, node, message):
        key = (node.lineno, message)
        if self.emit and key not in self._reported:
            self._reported.add(key)
            self.findings.append(Finding(
                rule="egress", path=self.ctx.mod.rel, line=node.lineno,
                symbol=self.qualname or "<module>", message=message))

    def _sink_hit(self, node, sink_name, labels):
        secrets = {l for l in labels if not _is_param(l)}
        if secrets:
            self._finding(node, f"SECRET value ({_fmt_labels(secrets)}) "
                                f"reaches wire sink `{sink_name}` without a "
                                f"registered sanitizer")
        for l in labels:
            if _is_param(l):
                self.summary.param_to_sink.setdefault(int(l[len(_PARAM):]),
                                                      sink_name)

    def _resolve_local(self, name: str) -> list[_FnInfo]:
        return self.ctx.by_name.get(name, [])

    # -- expressions ---------------------------------------------------------

    def ev(self, node, env) -> frozenset:
        if node is None or isinstance(node, ast.Constant):
            return frozenset()
        if isinstance(node, ast.Name):
            return env.get(node.id, frozenset())
        if isinstance(node, ast.Attribute):
            base = self.ev(node.value, env)
            if node.attr in self.policy.safe_attrs:
                return frozenset()
            if node.attr in self.policy.secret_attrs:
                try:
                    expr = ast.unparse(node)[:60]
                except Exception:
                    expr = f"<expr>.{node.attr}"
                desc = _SECRET_DESC.get(node.attr, "raw data")
                return base | {f"{desc} `{expr}`"}
            return base
        if isinstance(node, ast.Subscript):
            return self.ev(node.value, env)
        if isinstance(node, ast.Call):
            return self.ev_call(node, env)
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            out = frozenset()
            for elt in node.elts:
                out |= self.ev(elt, env)
            return out
        if isinstance(node, ast.Dict):
            out = frozenset()
            for v in node.values:
                out |= self.ev(v, env)
            return out
        if isinstance(node, ast.BinOp):
            return self.ev(node.left, env) | self.ev(node.right, env)
        if isinstance(node, ast.BoolOp):
            out = frozenset()
            for v in node.values:
                out |= self.ev(v, env)
            return out
        if isinstance(node, ast.Compare):
            # comparisons yield booleans (protocol metadata, e.g.
            # `block.y is not None`) — evaluate operands for sink
            # side-effects, but the boolean itself is clean
            self.ev(node.left, env)
            for comp in node.comparators:
                self.ev(comp, env)
            return frozenset()
        if isinstance(node, ast.Lambda):
            return frozenset()      # opaque, unanalyzed
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return frozenset()
            return self.ev(node.operand, env)
        if isinstance(node, ast.IfExp):
            return self.ev(node.body, env) | self.ev(node.orelse, env)
        if isinstance(node, ast.JoinedStr):
            out = frozenset()
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    out |= self.ev(v.value, env)
            return out
        if isinstance(node, ast.Starred):
            return self.ev(node.value, env)
        if isinstance(node, (ast.Await, ast.Yield, ast.YieldFrom)):
            return self.ev(getattr(node, "value", None), env)
        if isinstance(node, ast.NamedExpr):
            labels = self.ev(node.value, env)
            if isinstance(node.target, ast.Name):
                env[node.target.id] = labels
            return labels
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            inner = dict(env)
            for gen in node.generators:
                src = self.ev(gen.iter, inner)
                self._bind_target(gen.target, src, inner)
                for cond in gen.ifs:
                    self.ev(cond, inner)
            if isinstance(node, ast.DictComp):
                return self.ev(node.key, inner) | self.ev(node.value, inner)
            return self.ev(node.elt, inner)
        if isinstance(node, ast.Slice):
            out = frozenset()
            for part in (node.lower, node.upper, node.step):
                out |= self.ev(part, env)
            return out
        # fall-through: union of child expression taint
        out = frozenset()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                out |= self.ev(child, env)
        return out

    def ev_call(self, node: ast.Call, env) -> frozenset:
        # positional + keyword argument labels, in call order
        arg_labels = [self.ev(a, env) for a in node.args]
        kw_labels = [(kw.arg, self.ev(kw.value, env))
                     for kw in node.keywords]
        all_labels = arg_labels + [l for _, l in kw_labels]

        if isinstance(node.func, ast.Attribute):
            callee = node.func.attr
            base = self.ev(node.func.value, env)
            is_method_call = True
        elif isinstance(node.func, ast.Name):
            callee = node.func.id
            base = frozenset()
            is_method_call = False
        else:
            callee = None
            base = self.ev(node.func, env)
            is_method_call = False

        # 1. registered sanitizers break taint outright
        if callee in self.policy.sanitizers:
            return frozenset()
        # 2. wire sinks: every argument is inspected
        if callee in self.policy.sinks:
            for labels in all_labels:
                self._sink_hit(node, callee, labels)
            return frozenset()
        # 3. same-module functions: apply their summaries
        local = self._resolve_local(callee) if callee else []
        if local:
            result = frozenset()
            for fn in local:
                offset = 1 if (fn.is_method and is_method_call) else 0
                summary = self.summaries[(self.ctx.mod.rel, fn.qualname)]
                # map call arguments onto parameter positions
                bound: dict[int, frozenset] = {}
                for i, labels in enumerate(arg_labels):
                    bound[i + offset] = labels
                for kw, labels in kw_labels:
                    if kw in fn.params:
                        bound[fn.params.index(kw)] = labels
                for idx, sink in summary.param_to_sink.items():
                    for l in bound.get(idx, frozenset()):
                        if _is_param(l):
                            self.summary.param_to_sink.setdefault(
                                int(l[len(_PARAM):]), sink)
                        else:
                            self._finding(
                                node,
                                f"SECRET value ({_fmt_labels({l})}) reaches "
                                f"wire sink `{sink}` via `{fn.node.name}`")
                result |= frozenset(summary.returns_secret)
                for idx in summary.param_to_return:
                    result |= bound.get(idx, frozenset())
            return result
        # 4. neutral builtins: sizes/types/scalars, never payload
        if callee in self.policy.neutral_calls:
            return frozenset()
        # 5. unknown callable: conservatively propagate argument + receiver
        out = base
        for labels in all_labels:
            out |= labels
        return out

    # -- statements ----------------------------------------------------------

    def _bind_target(self, target, labels, env):
        if isinstance(target, ast.Name):
            env[target.id] = labels
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind_target(elt, labels, env)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, labels, env)
        elif isinstance(target, (ast.Attribute, ast.Subscript)):
            # storing into a container/field taints the base object
            base = target
            while isinstance(base, (ast.Attribute, ast.Subscript)):
                base = base.value
            if isinstance(base, ast.Name):
                env[base.id] = env.get(base.id, frozenset()) | labels

    def exec_block(self, stmts, env):
        for stmt in stmts:
            self.exec_stmt(stmt, env)

    def _merge(self, env, *branches):
        keys = set(env)
        for b in branches:
            keys |= set(b)
        for k in keys:
            merged = frozenset()
            for b in branches:
                merged |= b.get(k, frozenset())
            env[k] = merged

    def exec_stmt(self, stmt, env):
        if isinstance(stmt, ast.Assign):
            labels = self.ev(stmt.value, env)
            for t in stmt.targets:
                self._bind_target(t, labels, env)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind_target(stmt.target, self.ev(stmt.value, env), env)
        elif isinstance(stmt, ast.AugAssign):
            labels = self.ev(stmt.value, env) | self.ev(stmt.target, env)
            self._bind_target(stmt.target, labels, env)
        elif isinstance(stmt, ast.Expr):
            self.ev(stmt.value, env)
        elif isinstance(stmt, ast.Return):
            labels = self.ev(stmt.value, env)
            for l in labels:
                if _is_param(l):
                    self.summary.param_to_return.add(int(l[len(_PARAM):]))
                else:
                    self.summary.returns_secret.add(l)
        elif isinstance(stmt, ast.If):
            self.ev(stmt.test, env)
            b1, b2 = dict(env), dict(env)
            self.exec_block(stmt.body, b1)
            self.exec_block(stmt.orelse, b2)
            self._merge(env, b1, b2)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._bind_target(stmt.target, self.ev(stmt.iter, env), env)
            for _ in range(2):      # stabilize loop-carried taint
                body = dict(env)
                self.exec_block(stmt.body, body)
                self._merge(env, body)
            self.exec_block(stmt.orelse, env)
        elif isinstance(stmt, ast.While):
            self.ev(stmt.test, env)
            for _ in range(2):
                body = dict(env)
                self.exec_block(stmt.body, body)
                self._merge(env, body)
            self.exec_block(stmt.orelse, env)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                labels = self.ev(item.context_expr, env)
                if item.optional_vars is not None:
                    self._bind_target(item.optional_vars, labels, env)
            self.exec_block(stmt.body, env)
        elif isinstance(stmt, ast.Try):
            self.exec_block(stmt.body, env)
            branches = []
            for handler in stmt.handlers:
                h = dict(env)
                if handler.name:
                    h[handler.name] = frozenset()
                self.exec_block(handler.body, h)
                branches.append(h)
            if branches:
                self._merge(env, *branches)
            self.exec_block(stmt.orelse, env)
            self.exec_block(stmt.finalbody, env)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            pass    # analyzed separately with their own summaries
        elif isinstance(stmt, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.ev(child, env)
        elif isinstance(stmt, ast.Delete):
            pass
        else:       # Import/Global/Pass/Break/Continue/...
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.ev(child, env)

    # -- entry points --------------------------------------------------------

    def run_function(self, info: _FnInfo):
        env = {p: frozenset({f"{_PARAM}{i}"})
               for i, p in enumerate(info.params)}
        self.exec_block(info.node.body, env)

    def run_module_body(self):
        env = {}
        body = [s for s in self.ctx.mod.tree.body
                if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.ClassDef, ast.Import,
                                      ast.ImportFrom))]
        self.exec_block(body, env)


def run_egress(modules: list[ModuleSource],
               policy: Policy = DEFAULT_POLICY) -> list[Finding]:
    """Run the taint pass over parsed modules; returns raw findings
    (suppressions are applied by the caller via base.apply_suppressions)."""
    ctxs = [_ModuleCtx(m) for m in modules]
    summaries: dict[tuple, _FnSummary] = {}
    for ctx in ctxs:
        summaries[(ctx.mod.rel, "")] = _FnSummary()
        for fn in ctx.functions:
            summaries[(ctx.mod.rel, fn.qualname)] = _FnSummary()

    def sweep(emit, findings):
        for ctx in ctxs:
            for fn in ctx.functions:
                _Eval(ctx, policy, summaries, fn.qualname, emit,
                      findings).run_function(fn)
            _Eval(ctx, policy, summaries, "", emit,
                  findings).run_module_body()

    # fixpoint over interprocedural summaries (helper chains stabilize in
    # depth iterations; 4 covers everything in this repo with margin)
    prev = None
    for _ in range(4):
        sweep(emit=False, findings=None)
        state = tuple(s.state() for _, s in sorted(summaries.items()))
        if state == prev:
            break
        prev = state
    findings: list[Finding] = []
    sweep(emit=True, findings=findings)
    return findings
