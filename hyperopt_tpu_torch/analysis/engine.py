"""graftlint core: file context, captured-scope and thread-target
resolution, suppressions.

The engine is stdlib-only (``ast`` + ``tokenize``): it runs in the fast
tier on a bare CPU container and never imports ``torch`` (linting must
not build a program or touch a device).

Scope model
-----------
Rules are lexical and single-file.  A function is in *captured scope*
(the port's counterpart of the reference's jitted scope) when it is

* the step handed to a capture: the first argument of
  ``capture_graph(step, device)`` or ``torch.cuda.make_graphed_callables``,
  resolved through a ``functools.partial``, a conditional expression, a
  local alias, and a list, tuple or comprehension the step is drawn
  from (``capture_graph(step, dev) for step in steps``);
* called from the body of a ``with torch.cuda.graph(...)`` block;
* a same-file callee of a captured function (``self.method(...)`` of
  the enclosing class, or a name that resolves to a def of this file),
  or lexically nested inside one.

A CUDA graph records the launches of one call and replays only them:
host code inside a captured step runs once, at capture, and never again.

The engine also resolves THREAD ENTRY POINTS
(``threading.Thread(target=...)`` and ``executor.submit(fn, ...)``,
through a ``functools.partial`` wrapper) so the concurrency pack can
treat them as roots that enter with no lock held.  The fixture corpora
under ``tests/lint_fixtures/`` and ``tests/lint_fixtures_torch/`` pin
the behavior.

Suppressions
------------
``# graftlint: disable=GL303,GL501 reason`` on the violating line, or
on the ``def``/``class`` header line of any enclosing scope.  A pragma
naming an unknown rule ID is itself a finding (GL001).
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import hashlib
import io
import os
import re
import tokenize

__all__ = [
    "CAPTURE_CALLS",
    "Finding",
    "LintResult",
    "FileContext",
    "lint_source",
    "lint_paths",
    "unwrap_partial",
]

_PRAGMA_RE = re.compile(
    r"#\s*graftlint:\s*disable="
    r"([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
    r"(?:\s+(?P<reason>\S.*))?$"
)

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
_SCOPE_NODES = _FUNC_NODES + (ast.ClassDef,)
_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.GeneratorExp)

#: calls that capture their first argument, a step, into a CUDA graph
CAPTURE_CALLS = frozenset({"capture_graph", "make_graphed_callables"})


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    rule: str
    line: int
    col: int
    message: str
    source_line: str = ""

    def content_hash(self):
        """Identity that survives unrelated line shifts: the rule plus
        the stripped text of the violating line (baseline key)."""
        payload = f"{self.rule}:{self.source_line.strip()}"
        return hashlib.sha1(payload.encode("utf-8", "replace")).hexdigest()

    def to_dict(self):
        return {
            "path": self.path,
            "rule": self.rule,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "content_hash": self.content_hash(),
        }


@dataclasses.dataclass
class LintResult:
    findings: list
    n_files: int = 0
    n_suppressed: int = 0          # pragma-suppressed
    n_baseline_matched: int = 0    # grandfathered by the baseline
    baseline_size: int = 0

    @property
    def clean(self):
        return not self.findings


def terminal_name(node):
    """``a.b.c`` -> ``"c"``, ``name`` -> ``"name"``, else None."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def dotted_name(node):
    """Full dotted path of a Name/Attribute chain, or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def unwrap_partial(node):
    """``partial(f, ...)`` / ``functools.partial(f, ...)`` -> ``f``;
    anything else passes through.  A partial binds arguments -- it does
    not change which body runs, so thread-entry resolution must see
    through it."""
    if (
        isinstance(node, ast.Call)
        and terminal_name(node.func) == "partial"
        and node.args
    ):
        return node.args[0]
    return node


def is_graph_context(expr):
    """Whether a ``with`` item opens a CUDA graph capture
    (``torch.cuda.graph(g)``, ``cuda.graph(g)``)."""
    if not isinstance(expr, ast.Call):
        return False
    dn = dotted_name(expr.func) or ""
    return dn == "cuda.graph" or dn.endswith(".cuda.graph")


def walk_scope(node):
    """Yield ``node``'s descendants WITHOUT descending into nested
    function/lambda bodies -- a function's own statements only."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if not isinstance(child, _FUNC_NODES):
            stack.extend(ast.iter_child_nodes(child))


class FileContext:
    """Everything a rule checker needs about one parsed file."""

    def __init__(self, path, source, tree):
        self.path = path
        self.posix_path = path.replace(os.sep, "/")
        self.parts = [p for p in self.posix_path.split("/") if p]
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree

    # built on first use: the wire pack reads most files (the test
    # corpus) for their constants only and never needs them

    @functools.cached_property
    def parents(self):
        parents = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
        return parents

    @functools.cached_property
    def functions(self):
        return [n for n in ast.walk(self.tree) if isinstance(n, _FUNC_NODES)]

    @functools.cached_property
    def thread_targets(self):
        return self._resolve_thread_targets()

    @functools.cached_property
    def graph_blocks(self):
        """``with torch.cuda.graph(...)`` statements: their bodies are
        captured."""
        if ".graph(" not in self.source:
            return []
        return [
            n for n in ast.walk(self.tree)
            if isinstance(n, (ast.With, ast.AsyncWith))
            and any(is_graph_context(i.context_expr) for i in n.items)
        ]

    @functools.cached_property
    def captured(self):
        """The function nodes in captured scope (see the module
        docstring): the steps handed to a capture, the callees of a
        ``with torch.cuda.graph`` body, and their same-file callees."""
        if not self.graph_blocks and not any(c in self.source for c in CAPTURE_CALLS):
            return set()
        roots = []
        for node in ast.walk(self.tree):
            if (
                isinstance(node, ast.Call)
                and terminal_name(node.func) in CAPTURE_CALLS
                and node.args
            ):
                roots.extend(self.resolve_callables(node.args[0], node))
        for block in self.graph_blocks:
            for st in block.body:
                for n in [st, *walk_scope(st)]:
                    if isinstance(n, ast.Call):
                        roots.extend(self.resolve_callables(n.func, n))
        seen = set()
        stack = list(roots)
        while stack:
            fn = stack.pop()
            if fn in seen:
                continue
            seen.add(fn)
            for n in walk_scope(fn):
                if isinstance(n, ast.Call):
                    stack.extend(self.resolve_callables(n.func, n))
        return seen

    def in_captured_scope(self, node):
        if not self.captured and not self.graph_blocks:
            return False
        if isinstance(node, _FUNC_NODES) and node in self.captured:
            return True
        blocks = self.graph_blocks
        for a in self.ancestors(node):
            if isinstance(a, _FUNC_NODES) and a in self.captured:
                return True
            if blocks and a in blocks:
                return True
        return False

    # -- callable resolution -------------------------------------------------

    def _scopes(self, site):
        """The function scopes enclosing ``site``, innermost first, then
        the module."""
        out = [a for a in self.ancestors(site) if isinstance(a, _FUNC_NODES)]
        return out + [self.tree]

    def resolve_callables(self, expr, site, elem=0, _seen=None):
        """The defs (or lambdas) of this file that ``expr`` evaluated at
        ``site`` may call.  ``elem`` counts pending "an element of"
        levels: ``for step in steps`` resolves ``step`` as an element of
        ``steps``.  Unresolvable expressions give nothing."""
        seen = set() if _seen is None else _seen
        key = (id(expr), elem)
        if key in seen:
            return []
        seen.add(key)

        def again(e, n=elem, at=site):
            return self.resolve_callables(e, at, n, seen)

        if isinstance(expr, ast.IfExp):
            return again(expr.body) + again(expr.orelse)
        if isinstance(expr, ast.Name):
            return self._resolve_name(expr.id, site, elem, seen)
        if elem:
            if isinstance(expr, (ast.List, ast.Tuple, ast.Set)):
                return [f for e in expr.elts for f in again(e, elem - 1)]
            if isinstance(expr, _COMPREHENSIONS):
                return again(expr.elt, elem - 1, expr.elt)
            return []
        if isinstance(expr, ast.Lambda):
            return [expr]
        if isinstance(expr, ast.Call) and terminal_name(expr.func) == "partial":
            return again(expr.args[0]) if expr.args else []
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
        ):
            cls = next((a for a in self.ancestors(site)
                        if isinstance(a, ast.ClassDef)), None)
            if cls is None:
                return []
            return [m for m in cls.body
                    if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and m.name == expr.attr]
        return []

    def _resolve_name(self, name, site, elem, seen):
        """``name`` at ``site``: the innermost scope that binds it decides
        -- a def of that name, an assignment's value, or a loop or
        comprehension target (an element of its iterable), and for an
        element, what is appended to it.  A parameter
        binds it to something unknown."""
        for scope in self._scopes(site):
            own = list(walk_scope(scope)) if scope is not self.tree else [
                n for st in self.tree.body for n in [st, *walk_scope(st)]
            ]
            if scope is not self.tree and isinstance(scope, _FUNC_NODES):
                a = scope.args
                params = a.posonlyargs + a.args + a.kwonlyargs + [
                    p for p in (a.vararg, a.kwarg) if p is not None
                ]
                if any(p.arg == name for p in params):
                    return []
            defs = [n for n in own
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and n.name == name]
            out = [] if elem else list(defs)
            bound = bool(defs)
            for n in own:
                if isinstance(n, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name for t in n.targets
                ):
                    bound = True
                    out.extend(self.resolve_callables(n.value, n, elem, seen))
                elif isinstance(n, (ast.For, ast.AsyncFor, ast.comprehension)) and (
                    isinstance(n.target, ast.Name) and n.target.id == name
                ):
                    bound = True
                    out.extend(self.resolve_callables(n.iter, n.iter, elem + 1, seen))
                elif (
                    elem
                    and isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "append"
                    and isinstance(n.func.value, ast.Name)
                    and n.func.value.id == name
                    and n.args
                ):
                    # steps.append(step): an element of ``steps``
                    out.extend(self.resolve_callables(n.args[0], n, elem - 1, seen))
            if bound:
                return out
        return []

    # -- scope helpers -----------------------------------------------------

    def ancestors(self, node):
        n = self.parents.get(node)
        while n is not None:
            yield n
            n = self.parents.get(n)

    def enclosing_function(self, node):
        for a in self.ancestors(node):
            if isinstance(a, _FUNC_NODES):
                return a
        return None

    def scope_header_lines(self, node):
        """Line numbers of every enclosing def/class header (pragma
        placed there suppresses the whole scope)."""
        out = []
        if isinstance(node, _SCOPE_NODES):
            out.append(node.lineno)
        for a in self.ancestors(node):
            if isinstance(a, _SCOPE_NODES):
                out.append(a.lineno)
        return out

    def source_line(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, rule, node, message):
        f = Finding(
            path=self.posix_path,
            rule=rule,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
            source_line=self.source_line(getattr(node, "lineno", 1)),
        )
        # scope chain rides along (not part of identity) so the engine
        # can apply def-header pragmas
        object.__setattr__(f, "_scope_lines", self.scope_header_lines(node))
        return f

    # -- thread-entry-target resolution ------------------------------------

    def _resolve_thread_targets(self):
        """Map function/method defs that are THREAD ENTRY POINTS to
        ``{"daemon": bool}``.

        Resolves ``threading.Thread(target=...)`` and
        ``executor.submit(fn, ...)`` callables through a ``partial``
        wrapper, covering the three shapes the codebase uses:

        * ``Thread(target=self._loop)`` -- a BOUND METHOD of the
          enclosing class (by-name def lookup alone misses these);
        * ``Thread(target=functools.partial(self._method, arg))``;
        * ``Thread(target=local_fn)`` -- a plain (possibly nested) def.

        Rules treat these as concurrency ROOTS: a thread target enters
        with no lock held, whatever its in-class callers hold."""
        targets = {}
        defs_by_name = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(node.name, []).append(node)

        def enclosing_class(node):
            for a in self.ancestors(node):
                if isinstance(a, ast.ClassDef):
                    return a
            return None

        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            t = terminal_name(node.func)
            target = None
            if t == "Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = kw.value
            elif t == "submit" and node.args:
                # pool.submit(fn, ...): the executor's worker threads
                target = node.args[0]
            if target is None:
                continue
            target = unwrap_partial(target)
            daemon = any(
                kw.arg == "daemon"
                and isinstance(kw.value, ast.Constant)
                and bool(kw.value.value)
                for kw in node.keywords
            )
            resolved = []
            if (
                isinstance(target, ast.Attribute)
                and isinstance(target.value, ast.Name)
                and target.value.id == "self"
            ):
                cls = enclosing_class(node)
                if cls is not None:
                    for m in cls.body:
                        if (
                            isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                            and m.name == target.attr
                        ):
                            resolved.append(m)
            elif isinstance(target, ast.Name):
                resolved.extend(defs_by_name.get(target.id, ()))
            elif isinstance(target, ast.Lambda):
                resolved.append(target)
            for fn in resolved:
                info = targets.setdefault(fn, {"daemon": False})
                info["daemon"] = info["daemon"] or daemon
        return targets


def parse_pragmas(source):
    """Map line -> set of rule IDs disabled there (via tokenize, so
    pragmas inside strings don't count)."""
    pragmas = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _PRAGMA_RE.search(tok.string)
            if m:
                ids = {s.strip() for s in m.group(1).split(",") if s.strip()}
                pragmas.setdefault(tok.start[0], set()).update(ids)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass
    return pragmas


def lint_source(source, path="<string>", pack="ast"):
    """Lint one file's source; returns (findings, n_pragma_suppressed).

    ``pack`` selects the checker pack: ``"ast"`` (the default GL3xx
    invariants) or ``"trace"`` (the GL5xx graftrace concurrency pack,
    ``hyperopt-tpu-torch-lint --trace``).  Both share the engine, the pragma
    machinery, and the baseline format.

    Unparsable source is itself a finding (GL002) rather than an engine
    crash -- a syntax error in a diff must fail the lint test, not
    crash the harness with a traceback.
    """
    from .rules import CHECKERS, RULES

    if pack == "trace":
        from .trace import TRACE_CHECKERS as checkers
    elif pack == "ast":
        checkers = CHECKERS
    else:
        raise ValueError(f"unknown checker pack {pack!r}")

    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        f = Finding(
            path=path.replace(os.sep, "/"),
            rule="GL002",
            line=e.lineno or 1,
            col=(e.offset or 1) - 1,
            message=f"file does not parse: {e.msg}",
            source_line=(e.text or "").rstrip("\n"),
        )
        object.__setattr__(f, "_scope_lines", [])
        return [f], 0

    ctx = FileContext(path, source, tree)
    pragmas = parse_pragmas(source)

    raw = []
    for rule_id, checker in checkers:
        raw.extend(checker(ctx))

    # GL001: a pragma naming a rule NO pack defines is dead weight that
    # silently stops protecting when the real ID differs (ast pack
    # only, so the two packs never double-report the same pragma)
    if pack == "ast":
        for lineno, ids in pragmas.items():
            for rid in sorted(ids):
                if rid not in RULES:
                    f = ctx.finding(
                        "GL001",
                        ast.Pass(lineno=lineno, col_offset=0),
                        f"suppression names unknown rule ID {rid!r}",
                    )
                    raw.append(f)

    kept, n_suppressed = [], 0
    for f in raw:
        covering = set(pragmas.get(f.line, ()))
        for scope_line in getattr(f, "_scope_lines", ()):
            covering |= pragmas.get(scope_line, set())
        if f.rule in covering:
            n_suppressed += 1
        else:
            kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept, n_suppressed


def iter_python_files(paths):
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs
                    if d != "__pycache__" and not d.startswith(".")
                )
                out.extend(
                    os.path.join(root, f) for f in sorted(files)
                    if f.endswith(".py")
                )
        elif p.endswith(".py") or os.path.isfile(p):
            out.append(p)
        else:
            raise FileNotFoundError(p)
    return out


def lint_paths(paths, baseline=None, root=None, pack="ast"):
    """Lint files/directories; apply ``baseline`` (a loaded baseline
    multiset, see :mod:`.baseline`) to filter grandfathered findings.

    ``root`` anchors finding paths (default: the process cwd) -- pass
    the repo root when calling from elsewhere so paths keep matching
    the committed baseline's repo-relative keys.  ``pack`` selects the
    checker pack (see :func:`lint_source`).
    """
    from .baseline import apply_baseline

    files = iter_python_files(paths)
    findings, n_suppressed = [], 0
    for fp in files:
        try:
            with open(fp, encoding="utf-8", errors="replace") as fh:
                source = fh.read()
        except OSError as e:
            raise FileNotFoundError(f"cannot read {fp}: {e}") from e
        rel = (
            os.path.relpath(fp, start=root)
            if root is not None or os.path.isabs(fp) else fp
        )
        fs, ns = lint_source(source, path=rel, pack=pack)
        findings.extend(fs)
        n_suppressed += ns
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    n_matched = 0
    baseline_size = 0
    if baseline is not None:
        baseline_size = sum(baseline.values())
        findings, n_matched = apply_baseline(findings, baseline)
    return LintResult(
        findings=findings,
        n_files=len(files),
        n_suppressed=n_suppressed,
        n_baseline_matched=n_matched,
        baseline_size=baseline_size,
    )
