"""graftwire: static wire-protocol & fault-surface contract checker
(the GL6xx pack, ``hyperopt-tpu-torch-lint --wire``).

The port serves the reference's three-front wire protocol (service + router TCP
fronts, ``RemoteStudy``/``FrameConn`` clients) and a fault surface of
crash-point registries plus a name-keyed typed-error reply mapping.
Those seams are STRING-matched at runtime -- ``op == "tell"``,
``error_type`` names an exception class, ``fs.crashpoint("name")`` --
so nothing in the type system stops an op added to ``_handle_request``
without a client counterpart, a reply-field rename, or a crash point no
test ever arms from drifting silently.  graftwire closes that gap:
extract every surface statically (stdlib ``ast`` only, zero test
execution), cross-reference them, and pin the reply shapes in a
committed manifest (``hyperopt_tpu_torch/analysis/wire_contracts.json``,
the port's own; the reference package pins its own beside it).

Extracted surfaces
------------------
* **server ops**: every ``op == "x"`` / ``op in (...)`` dispatch arm of
  ``service._handle_request`` (the "service" front) and
  ``RouterServer.handle_request`` (the "router" front), plus the
  ``hello`` proto negotiation in each front's connection handler; per
  op, the union of constant keys over the branch's ``return {...}``
  dict literals (one level of local-helper resolution, ``"*"`` for
  dynamic parts such as ``**service.health()``).
* **client ops**: every ``{"op": <const>}`` dict literal and
  ``call(op="<const>")`` keyword send in ``client.py``
  (``RemoteStudy``), ``router.py`` backend call-sites, ``frames.py``
  (the ``hello`` dial), and ``obs/cli.py``; the same shapes in the
  port's tests (``tests/test_torch_*.py``) count as caller evidence.
* **typed errors**: ``exceptions.py`` classes transitively subclassing
  ``ServeError`` vs the client reply seam (``_REPLY_ERRORS`` keys and
  by-name special cases in ``client.py``).
* **crash points**: every ``*_CRASH_POINTS`` registry tuple in
  ``faults.py``/``netfaults.py`` vs arming evidence in the port's tests --
  a point armed by string literal, or a registry iterated by name in a
  test file that calls ``arm(``.

Rules
-----
* **GL601** a client-sent op no front handles, a handled op with no
  client/test caller (dead wire surface), or a GLOBAL op one front
  handles that the other refuses untyped (the router forwards
  study-keyed ops generically, so only no-name ops can be asymmetric).
* **GL602** reply-field drift per op against the committed
  ``wire_contracts.json`` -- field-level diffs, accepted only via
  ``hyperopt-tpu-torch-lint --wire --update-contracts``.  The typed
  error-reply shape (``_serve_error_reply``) is pinned the same way.
* **GL603** a ``ServeError`` subclass unmapped at the client reply
  seam: it crosses the wire as an ``error_type`` name and surfaces as a
  generic ``RuntimeError`` instead of the typed class.
* **GL604** a registered crash point never armed by any test -- dead
  fault surface (the registries exist so chaos suites iterate them).
* **GL605** a durable write seam (``fsync`` / ``rename`` / WAL
  ``append`` under ``serve/`` or ``distributed/``) whose enclosing
  function has no ``crashpoint(`` call in scope: a kill inside that
  window is untestable.  The fault-injection seam itself
  (``faults.py`` / ``netfaults.py``) is exempt -- it IS the
  passthrough.
* **GL606** a ``retry_after``-carrying reply built from a bare numeric
  without the ``RETRY_AFTER_CAP``/jitter path -- a hand-built hint can
  exceed the cap the backoff loops rely on.

Findings ride the standard pragma machinery (``# graftlint:
disable=GL60x reason`` on the line or an enclosing def/class header)
and the committed baseline; everything is cwd-independent (package
files and the default manifest resolve against the package's parent).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os

from .engine import (
    FileContext,
    Finding,
    dotted_name,
    parse_pragmas,
    terminal_name,
    walk_scope,
)

__all__ = [
    "WireResult",
    "analyze",
    "check_wire",
    "default_contracts_path",
    "load_contracts",
    "write_contracts",
    "DEFAULT_CONTRACTS",
]

PACKAGE = "hyperopt_tpu_torch"
DEFAULT_CONTRACTS = f"{PACKAGE}/analysis/wire_contracts.json"
CONTRACTS_VERSION = 1

#: the package files each extraction surface reads (repo-relative,
#: posix).  A role lists FILES, not globs, so a new front must be
#: registered here deliberately -- the fixture corpus drives the same
#: roles with synthetic sources.
SERVER_FILES = (
    f"{PACKAGE}/serve/service.py",
    f"{PACKAGE}/serve/router.py",
)
CLIENT_FILES = (
    f"{PACKAGE}/client.py",
    f"{PACKAGE}/serve/router.py",
    f"{PACKAGE}/serve/frames.py",
    f"{PACKAGE}/obs/cli.py",
)
REPLY_SEAM_FILES = (f"{PACKAGE}/client.py",)
EXCEPTION_FILES = (f"{PACKAGE}/exceptions.py",)
FAULT_FILES = (
    f"{PACKAGE}/distributed/faults.py",
    f"{PACKAGE}/distributed/netfaults.py",
)
#: GL605/GL606 scan scope: the crash-consistency surface.  faults.py /
#: netfaults.py are the injection seam itself (their rename/fsync ARE
#: the passthrough primitives every crashpoint brackets).
DURABLE_DIRS = (f"{PACKAGE}/serve", f"{PACKAGE}/distributed")
#: the port's tests are the only caller and arming evidence: the
#: reference's suites arm the reference's crash points
TEST_PREFIX = "test_torch_"
DURABLE_EXCLUDE = ("faults.py", "netfaults.py")


@dataclasses.dataclass
class WireResult:
    """What one ``--wire`` run produced (the reporter's input)."""

    findings: list
    ops_checked: int = 0
    contract_drift: int = 0
    crash_points_total: int = 0
    crash_points_armed: int = 0
    errors_checked: int = 0
    n_files: int = 0
    n_suppressed: int = 0
    n_baseline_matched: int = 0
    baseline_size: int = 0
    contracts_path: str = ""
    updated: bool = False

    @property
    def clean(self):
        return not self.findings


def repo_root():
    """The package parent -- the anchor for finding paths and the
    default manifest location (cwd-independent by construction)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))


def default_contracts_path(root=None):
    return os.path.join(root or repo_root(), DEFAULT_CONTRACTS)


def load_contracts(path):
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("version") != CONTRACTS_VERSION:
        raise ValueError(
            f"wire contracts manifest {path!r} has version "
            f"{payload.get('version')!r}; this checker reads version "
            f"{CONTRACTS_VERSION}"
        )
    return payload


def write_contracts(path, fronts, error_reply):
    payload = {
        "version": CONTRACTS_VERSION,
        "fronts": {
            front: {op: sorted(fields) for op, fields in ops.items()}
            for front, ops in fronts.items()
        },
        "error_reply": sorted(error_reply),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# extraction helpers (pure ast -- shared by the real repo scan and the
# fixture corpus)
# ---------------------------------------------------------------------------


def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _is_op_load(node):
    """``op`` (the dispatch local) or ``req.get("op")``."""
    if isinstance(node, ast.Name) and node.id == "op":
        return True
    return (
        isinstance(node, ast.Call)
        and terminal_name(node.func) == "get"
        and node.args
        and _const_str(node.args[0]) == "op"
    )


def _op_compare_values(test):
    """The constant op strings an ``if`` dispatch test matches, or []."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1):
        return []
    if not _is_op_load(test.left):
        return []
    cmp = test.comparators[0]
    if isinstance(test.ops[0], ast.Eq):
        s = _const_str(cmp)
        return [s] if s is not None else []
    if isinstance(test.ops[0], ast.In) and isinstance(cmp, (ast.Tuple, ast.List)):
        out = [_const_str(e) for e in cmp.elts]
        return [s for s in out if s is not None]
    return []


def _dict_fields(d):
    fields = set()
    for k in d.keys:
        s = _const_str(k)
        fields.add(s if s is not None else "*")  # None key = ** unpack
    return fields


def _local_helper(ctx, fn, call):
    """Resolve ``return helper(...)`` / ``return self._helper(...)`` to
    the module-level def or same-class method, one level deep."""
    t = terminal_name(call.func)
    if t is None:
        return None
    for node in ctx.tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == t:
            return node
    for anc in ctx.ancestors(fn):
        if isinstance(anc, ast.ClassDef):
            for m in anc.body:
                if isinstance(m, ast.FunctionDef) and m.name == t:
                    return m
    return None


def _return_fields(ctx, fn, scope, depth=0):
    """Union of reply fields over every ``return`` in ``scope``."""
    fields = set()
    for node in walk_scope(scope):
        if not isinstance(node, ast.Return) or node.value is None:
            continue
        v = node.value
        if isinstance(v, ast.Dict):
            fields |= _dict_fields(v)
        elif isinstance(v, ast.Call) and depth == 0:
            helper = _local_helper(ctx, fn, v)
            if helper is not None:
                fields |= _return_fields(ctx, helper, helper, depth=1)
            else:
                fields.add("*")
        else:
            fields.add("*")
    return fields


def _name_gate_line(fn):
    """Line of the ``name = req.get("study"/"name")`` prelude that
    splits GLOBAL ops from study-keyed ops, or None."""
    for node in walk_scope(fn):
        if not (isinstance(node, ast.Assign) and node.targets):
            continue
        vals = [node.value]
        if isinstance(node.value, ast.BoolOp):
            vals = node.value.values
        for v in vals:
            if (
                isinstance(v, ast.Call)
                and terminal_name(v.func) == "get"
                and v.args
                and _const_str(v.args[0]) in ("study", "name")
            ):
                return node.lineno
    return None


def _extract_fronts(ctxs):
    """``{front: {op: {"line", "path", "fields", "global", "ctx",
    "node"}}}`` from every handler function in ``ctxs``.

    A module-level ``_handle_request`` def is the "service" front; a
    ``handle_request`` method is the "router" front.  ``hello`` (proto
    negotiation, handled in the connection loop rather than the
    dispatch function) attaches to whichever front(s) live in the same
    file.
    """
    fronts = {}
    for ctx in ctxs:
        file_fronts = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            front = None
            if node.name == "_handle_request":
                front = "service"
            elif node.name == "handle_request" and ctx.enclosing_function(
                node
            ) is None and any(
                isinstance(a, ast.ClassDef) for a in ctx.ancestors(node)
            ):
                front = "router"
            if front is None:
                continue
            file_fronts.append(front)
            ops = fronts.setdefault(front, {})
            gate = _name_gate_line(node)
            for sub in walk_scope(node):
                if not isinstance(sub, ast.If):
                    continue
                fields = _return_fields(ctx, node, sub)
                if not fields:
                    # an op comparison that returns nothing is a retry/
                    # bookkeeping tweak inside a forward loop, not a
                    # dispatch arm
                    continue
                for op in _op_compare_values(sub.test):
                    info = ops.setdefault(op, {
                        "line": sub.lineno,
                        "path": ctx.posix_path,
                        "fields": set(),
                        "global": gate is None or sub.lineno < gate,
                        "ctx": ctx,
                        "node": sub,
                    })
                    info["fields"] |= fields
        if not file_fronts:
            continue
        # hello: `if req.get("op") == "hello":` in the connection loop;
        # reply fields come from dict assigns + subscript stores there
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.If):
                continue
            if _op_compare_values(node.test) != ["hello"]:
                continue
            fields = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    if isinstance(sub.value, ast.Dict):
                        fields |= _dict_fields(sub.value)
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Subscript):
                            s = _const_str(tgt.slice)
                            fields.add(s if s is not None else "*")
            for front in file_fronts:
                fronts.setdefault(front, {}).setdefault("hello", {
                    "line": node.lineno,
                    "path": ctx.posix_path,
                    "fields": fields,
                    "global": True,
                    "ctx": ctx,
                    "node": node,
                })
    return fronts


def _sent_ops(ctx):
    """Every constant op this file sends: ``{"op": "x"}`` dict literals
    and ``call(op="x")`` keyword sends (the test-harness idiom).
    Yields ``(op, node, has_name)`` where ``has_name`` records whether
    the send carries a ``name``/``study`` key -- the router forwards
    study-keyed requests generically, so named sends are never
    front-asymmetric."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Dict):
            op, has_name = None, False
            for k, v in zip(node.keys, node.values):
                ks = _const_str(k)
                if ks == "op":
                    op = _const_str(v)
                elif ks in ("name", "study"):
                    has_name = True
            if op is not None:
                yield op, node, has_name
        elif isinstance(node, ast.Call):
            op, has_name = None, False
            for kw in node.keywords:
                if kw.arg == "op":
                    op = _const_str(kw.value)
                elif kw.arg in ("name", "study"):
                    has_name = True
            if op is not None:
                yield op, node, has_name


def _error_reply_fields(ctxs):
    """The ``_serve_error_reply`` shape: dict-literal keys plus
    ``reply[...] = ...`` stores.  Returns (fields, line, ctx) or
    None."""
    for ctx in ctxs:
        for node in ast.walk(ctx.tree):
            if not (
                isinstance(node, ast.FunctionDef)
                and node.name == "_serve_error_reply"
            ):
                continue
            fields = set()
            for sub in walk_scope(node):
                if isinstance(sub, ast.Dict):
                    fields |= _dict_fields(sub)
                elif isinstance(sub, ast.Assign):
                    for tgt in sub.targets:
                        if isinstance(tgt, ast.Subscript):
                            s = _const_str(tgt.slice)
                            fields.add(s if s is not None else "*")
            return fields, node.lineno, ctx
    return None


def _serve_error_subclasses(ctxs):
    """``{name: (line, ctx)}`` of classes transitively subclassing
    ServeError (the base itself excluded)."""
    bases, sites = {}, {}
    for ctx in ctxs:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                bases[node.name] = [
                    terminal_name(b) or "" for b in node.bases
                ]
                sites[node.name] = (node.lineno, node, ctx)

    def descends(name, seen):
        if name == "ServeError":
            return True
        if name in seen:
            return False
        return any(
            descends(b, seen | {name}) for b in bases.get(name, ())
        )

    return {
        name: sites[name]
        for name in bases
        if name != "ServeError" and descends(name, set())
    }


def _crash_registries(ctxs):
    """``[(registry_name, [(point, line)], ctx)]`` from module-level
    ``*_CRASH_POINTS = ("...", ...)`` tuples (the concatenated
    ``ALL_CRASH_POINTS`` is not a registry)."""
    out = []
    for ctx in ctxs:
        for node in ctx.tree.body:
            if not (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
            ):
                continue
            name = node.targets[0].id
            if (
                not name.endswith("CRASH_POINTS")
                or name == "ALL_CRASH_POINTS"
                or not isinstance(node.value, (ast.Tuple, ast.List))
            ):
                continue
            points = []
            for elt in node.value.elts:
                s = _const_str(elt)
                if s is not None:
                    points.append((s, elt.lineno, elt))
            out.append((name, points, ctx))
    return out


def _test_evidence(test_ctxs):
    """(sent_ops, string_constants, iterated_registries) across the
    test corpus.  A registry counts as iterated when its NAME appears
    in a file that also calls ``arm(`` -- the parametrize-over-the-
    tuple idiom the chaos suites use."""
    ops, strings, iterated = set(), set(), set()
    named = set()
    for ctx in test_ctxs:
        for op, _node, has_name in _sent_ops(ctx):
            ops.add(op)
            if has_name:
                named.add(op)
        names, has_arm = set(), False
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                strings.add(node.value)
            elif isinstance(node, ast.Name):
                names.add(node.id)
            elif isinstance(node, ast.ImportFrom):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.Call):
                if terminal_name(node.func) == "arm":
                    has_arm = True
        if has_arm:
            iterated.update(
                n for n in names if n.endswith("CRASH_POINTS")
            )
    return ops, named, strings, iterated


def _durable_sites(ctx):
    """``{fn_node: [(line, kind)]}`` of fsync/rename/WAL-append calls
    whose enclosing function lacks a ``crashpoint(`` call."""
    per_fn = {}
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        t = terminal_name(node.func)
        kind = None
        if t == "fsync":
            kind = "fsync"
        elif t == "rename":
            kind = "rename"
        elif t == "append":
            recv = dotted_name(node.func) or ""
            recv = recv.rsplit(".", 1)[0] if "." in recv else ""
            if "wal" in recv.lower():
                kind = "WAL append"
        if kind is None:
            continue
        fn = ctx.enclosing_function(node)
        if fn is None:
            continue
        per_fn.setdefault(fn, []).append((node.lineno, kind))
    out = {}
    for fn, sites in per_fn.items():
        bracketed = any(
            isinstance(n, ast.Call)
            and terminal_name(n.func) == "crashpoint"
            for n in walk_scope(fn)
        )
        if not bracketed:
            out[fn] = sorted(sites)
    return out


def _retry_after_values(ctx):
    """Every expression assigned to a reply's ``retry_after`` field."""
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if _const_str(k) == "retry_after":
                    yield v, node
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if (
                    isinstance(tgt, ast.Subscript)
                    and _const_str(tgt.slice) == "retry_after"
                ):
                    yield node.value, node


def _numeric_without_cap(expr):
    has_num = any(
        isinstance(n, ast.Constant)
        and isinstance(n.value, (int, float))
        and not isinstance(n.value, bool)
        for n in ast.walk(expr)
    )
    has_cap = any(
        terminal_name(n) == "RETRY_AFTER_CAP"
        for n in ast.walk(expr)
        if isinstance(n, (ast.Name, ast.Attribute))
    )
    return has_num and not has_cap


# ---------------------------------------------------------------------------
# the pack
# ---------------------------------------------------------------------------


def _parse(path, source, parsed):
    """FileContext for ``path`` (memoized per analyze call); a syntax
    error yields a GL002 finding instead of a crash."""
    if path in parsed:
        return parsed[path]
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        f = Finding(
            path=path, rule="GL002", line=e.lineno or 1,
            col=(e.offset or 1) - 1,
            message=f"file does not parse: {e.msg}",
            source_line=(e.text or "").rstrip("\n"),
        )
        object.__setattr__(f, "_scope_lines", [])
        parsed[path] = (None, [f])
        return parsed[path]
    parsed[path] = (FileContext(path, source, tree), [])
    return parsed[path]


def analyze(server=None, clients=None, reply_seam=None, exceptions=None,
            faults=None, durable=None, tests=None, contracts=None,
            update=False):
    """Run the GL6xx pack over explicit role -> {path: source} maps.

    This is the fixture-facing core: :func:`check_wire` feeds it the
    real repo files, the fixture corpus feeds it miniature synthetic
    universes, and the mutation kill-checks feed it the real sources
    with one seam textually broken -- all with ZERO test execution.

    Returns ``(findings, stats, fresh_contracts)`` where ``stats`` has
    ``ops_checked`` / ``contract_drift`` / ``crash_points_total`` /
    ``crash_points_armed`` / ``errors_checked`` / ``n_suppressed`` /
    ``n_files``, and ``fresh_contracts`` is the would-be-committed
    manifest payload.
    """
    server = server or {}
    clients = clients or {}
    reply_seam = reply_seam or {}
    exceptions = exceptions or {}
    faults = faults or {}
    durable = durable or {}
    tests = tests or {}

    parsed = {}
    findings = []

    def ctxs_of(role):
        out = []
        for path in sorted(role):
            ctx, errs = _parse(path, role[path], parsed)
            findings.extend(errs)
            if ctx is not None:
                out.append(ctx)
        return out

    server_ctxs = ctxs_of(server)
    client_ctxs = ctxs_of(clients)
    seam_ctxs = ctxs_of(reply_seam)
    exc_ctxs = ctxs_of(exceptions)
    fault_ctxs = ctxs_of(faults)
    durable_ctxs = ctxs_of(durable)
    test_ctxs = ctxs_of(tests)

    fronts = _extract_fronts(server_ctxs)
    test_ops, test_named, test_strings, iterated = _test_evidence(test_ctxs)

    # -- GL601: op-surface symmetry -------------------------------------
    handled = {
        op for ops in fronts.values() for op in ops
    }
    client_sends = []
    for ctx in client_ctxs:
        for op, node, has_name in _sent_ops(ctx):
            client_sends.append((op, node, has_name, ctx))
    for op, node, _has_name, ctx in client_sends:
        if op not in handled:
            findings.append(ctx.finding(
                "GL601", node,
                f"client sends op {op!r} but no front handles it "
                f"(service handles {sorted(fronts.get('service', {}))}, "
                f"router handles {sorted(fronts.get('router', {}))})",
            ))
    called = {op for op, _, _, _ in client_sends} | test_ops
    named_ops = {
        op for op, _, has_name, _ in client_sends if has_name
    } | test_named
    for front, ops in sorted(fronts.items()):
        for op, info in sorted(ops.items()):
            if op not in called:
                findings.append(info["ctx"].finding(
                    "GL601", info["node"],
                    f"op {op!r} on the {front} front has no client or "
                    "test caller -- dead wire surface or missing "
                    "coverage; call it from a client/test or delete "
                    "the handler arm",
                ))
    # front asymmetry: a no-study-name op only one front handles -- the
    # router forwards study-keyed sends generically (``named_ops``:
    # every observed send of the op carries a name), but a global op it
    # does not dispatch gets an untyped refusal
    if "service" in fronts and "router" in fronts:
        for op, info in sorted(fronts["service"].items()):
            if (
                info["global"]
                and op not in fronts["router"]
                and op not in named_ops
            ):
                findings.append(info["ctx"].finding(
                    "GL601", info["node"],
                    f"global op {op!r} is handled by the service front "
                    "but not by the router front: a fleet client gets "
                    "an untyped 'needs a study name' refusal -- handle "
                    "or broadcast it in RouterServer.handle_request",
                ))

    # -- GL602: reply contracts vs the committed manifest ---------------
    fresh_fronts = {
        front: {op: sorted(info["fields"]) for op, info in ops.items()}
        for front, ops in fronts.items()
    }
    err = _error_reply_fields(server_ctxs)
    fresh_error_reply = sorted(err[0]) if err else []
    fresh_contracts = {
        "version": CONTRACTS_VERSION,
        "fronts": fresh_fronts,
        "error_reply": fresh_error_reply,
    }

    drift_ops = set()
    if not update and contracts is not None:
        stored_fronts = contracts.get("fronts", {})
        for front, ops in sorted(fronts.items()):
            stored_ops = stored_fronts.get(front, {})
            for op, info in sorted(ops.items()):
                stored = stored_ops.get(op)
                fresh = sorted(info["fields"])
                if stored is None:
                    drift_ops.add((front, op))
                    findings.append(info["ctx"].finding(
                        "GL602", info["node"],
                        f"no committed reply contract for op {op!r} on "
                        f"the {front} front; pin it with "
                        "`hyperopt-tpu-torch-lint --wire --update-contracts`",
                    ))
                elif sorted(stored) != fresh:
                    added = sorted(set(fresh) - set(stored))
                    removed = sorted(set(stored) - set(fresh))
                    parts = []
                    if removed:
                        parts.append(f"field(s) {removed} removed")
                    if added:
                        parts.append(f"field(s) {added} added")
                    drift_ops.add((front, op))
                    findings.append(info["ctx"].finding(
                        "GL602", info["node"],
                        f"reply contract drift for op {op!r} on the "
                        f"{front} front: {', '.join(parts)} (committed "
                        f"{sorted(stored)} != extracted {fresh}); "
                        "accept deliberate changes with "
                        "`hyperopt-tpu-torch-lint --wire --update-contracts`",
                    ))
            # stale manifest rows: ops the front no longer dispatches
            for op in sorted(set(stored_ops) - set(ops)):
                drift_ops.add((front, op))
                f = Finding(
                    path=DEFAULT_CONTRACTS, rule="GL602", line=1, col=0,
                    message=f"manifest pins a reply contract for op "
                    f"{op!r} on the {front} front, which no longer "
                    "dispatches it; refresh with `hyperopt-tpu-torch-lint "
                    "--wire --update-contracts`",
                )
                object.__setattr__(f, "_scope_lines", [])
                findings.append(f)
        stored_err = contracts.get("error_reply")
        if err is not None and stored_err is not None and (
            sorted(stored_err) != fresh_error_reply
        ):
            fields, line, ctx = err
            drift_ops.add(("service", "_serve_error_reply"))
            findings.append(ctx.finding(
                "GL602",
                ast.Pass(lineno=line, col_offset=0),
                "typed error-reply contract drift: committed "
                f"{sorted(stored_err)} != extracted {fresh_error_reply}"
                "; accept with `hyperopt-tpu-torch-lint --wire "
                "--update-contracts`",
            ))

    # -- GL603: typed-error surface vs the client reply seam ------------
    subclasses = _serve_error_subclasses(exc_ctxs)
    seam_strings = set()
    for ctx in seam_ctxs:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                seam_strings.add(node.value)
    for name, (line, node, ctx) in sorted(subclasses.items()):
        if name not in seam_strings:
            findings.append(ctx.finding(
                "GL603", node,
                f"ServeError subclass {name!r} is unmapped at the "
                "client reply seam: it crosses the wire as error_type "
                f"{name!r} and surfaces as a generic RuntimeError -- "
                "add it to _REPLY_ERRORS (or a by-name special case)",
            ))

    # -- GL604: crash points vs test arming -----------------------------
    registries = _crash_registries(fault_ctxs)
    cp_total = cp_armed = 0
    for reg_name, points, ctx in registries:
        for point, line, node in points:
            cp_total += 1
            if point in test_strings or reg_name in iterated:
                cp_armed += 1
            else:
                findings.append(ctx.finding(
                    "GL604", node,
                    f"crash point {point!r} ({reg_name}) is never "
                    "armed by any test -- dead fault surface; arm it "
                    "in a chaos suite or delete it from the registry",
                ))

    # -- GL605: durable write seams without a crash point in scope ------
    for ctx in durable_ctxs:
        for fn, sites in sorted(
            _durable_sites(ctx).items(), key=lambda kv: kv[0].lineno
        ):
            kinds = ", ".join(
                f"{kind} (L{line})" for line, kind in sites
            )
            findings.append(ctx.finding(
                "GL605", fn,
                f"durable write seam in {fn.name!r} ({kinds}) with no "
                "crash point in scope: a kill inside this window is "
                "untestable -- bracket it with fs.crashpoint(...) or "
                "route it through a primitive that does",
            ))

    # -- GL606: hand-built retry_after outside the cap/jitter path ------
    for ctx in server_ctxs:
        for expr, node in _retry_after_values(ctx):
            if _numeric_without_cap(expr):
                findings.append(ctx.finding(
                    "GL606", node,
                    "reply carries a hand-built numeric retry_after "
                    "without the RETRY_AFTER_CAP/jitter path: wrap it "
                    "in min(..., RETRY_AFTER_CAP) or derive it from "
                    "the scheduler's jittered hint",
                ))

    # -- pragma suppression (same engine semantics as lint_source) ------
    pragmas_by_path = {
        path: parse_pragmas(src)
        for role in (server, clients, reply_seam, exceptions, faults,
                     durable, tests)
        for path, src in role.items()
    }
    kept, n_suppressed = [], 0
    for f in findings:
        pragmas = pragmas_by_path.get(f.path, {})
        covering = set(pragmas.get(f.line, ()))
        for scope_line in getattr(f, "_scope_lines", ()):
            covering |= pragmas.get(scope_line, set())
        if f.rule in covering:
            n_suppressed += 1
        else:
            kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    stats = {
        "ops_checked": sum(len(ops) for ops in fronts.values()),
        "contract_drift": len(drift_ops),
        "crash_points_total": cp_total,
        "crash_points_armed": cp_armed,
        "errors_checked": len(subclasses),
        "n_suppressed": n_suppressed,
        "n_files": len(parsed),
    }
    return kept, stats, fresh_contracts


def _load_role(root, paths):
    out = {}
    for rel in paths:
        fp = os.path.join(root, rel)
        with open(fp, encoding="utf-8", errors="replace") as f:
            out[rel] = f.read()
    return out


def _iter_durable_files(root):
    out = []
    for d in DURABLE_DIRS:
        full = os.path.join(root, d)
        if not os.path.isdir(full):
            continue
        for name in sorted(os.listdir(full)):
            if name.endswith(".py") and name not in DURABLE_EXCLUDE:
                out.append(f"{d}/{name}")
    return out


def _iter_test_files(root):
    """Top-level ``tests/test_torch_*.py`` only: the fixture corpus
    underneath (tests/lint_fixtures/) contains synthetic registries and
    handler decoys that must never count as arming/caller evidence, and
    the reference's own suites exercise the reference's surfaces."""
    tdir = os.path.join(root, "tests")
    if not os.path.isdir(tdir):
        return []
    return [
        f"tests/{name}" for name in sorted(os.listdir(tdir))
        if name.startswith(TEST_PREFIX) and name.endswith(".py")
        and os.path.isfile(os.path.join(tdir, name))
    ]


def check_wire(contracts_path=None, update=False, root=None,
               sources=None, baseline=None):
    """Run the GL6xx pack over the real repo surfaces.

    ``contracts_path`` defaults to the package's committed manifest; ``update=True`` re-pins it instead of diffing (the other
    rules still report).  ``sources`` maps repo-relative paths to
    replacement source text (the mutation kill-checks' seam);
    ``baseline`` is a loaded baseline multiset.  Returns
    :class:`WireResult`.  Cwd-independent: files and the default
    manifest resolve against the package parent.
    """
    from .baseline import apply_baseline

    rootdir = root or repo_root()
    path = contracts_path or default_contracts_path(rootdir)

    roles = {
        "server": _load_role(rootdir, SERVER_FILES),
        "clients": _load_role(rootdir, CLIENT_FILES),
        "reply_seam": _load_role(rootdir, REPLY_SEAM_FILES),
        "exceptions": _load_role(rootdir, EXCEPTION_FILES),
        "faults": _load_role(rootdir, FAULT_FILES),
        "durable": _load_role(rootdir, _iter_durable_files(rootdir)),
        "tests": _load_role(rootdir, _iter_test_files(rootdir)),
    }
    if sources:
        for role in roles.values():
            for rel in role:
                if rel in sources:
                    role[rel] = sources[rel]

    contracts = None
    if not update and os.path.exists(path):
        contracts = load_contracts(path)
    manifest_missing = contracts is None and not update

    findings, stats, fresh = analyze(
        contracts=contracts, update=update, **roles
    )
    if manifest_missing:
        # analyze() treats a None manifest as "skip the diff"; a
        # MISSING committed manifest is itself drift
        f = Finding(
            path=os.path.basename(path), rule="GL602", line=1, col=0,
            message="no committed wire contracts manifest; pin it with "
            "`hyperopt-tpu-torch-lint --wire --update-contracts`",
        )
        object.__setattr__(f, "_scope_lines", [])
        findings = sorted(
            findings + [f],
            key=lambda f: (f.path, f.line, f.col, f.rule),
        )
        stats["contract_drift"] += 1

    if update:
        write_contracts(path, fresh["fronts"], fresh["error_reply"])

    n_matched = 0
    baseline_size = 0
    if baseline is not None:
        baseline_size = sum(baseline.values())
        findings, n_matched = apply_baseline(findings, baseline)

    return WireResult(
        findings=findings,
        ops_checked=stats["ops_checked"],
        contract_drift=stats["contract_drift"],
        crash_points_total=stats["crash_points_total"],
        crash_points_armed=stats["crash_points_armed"],
        errors_checked=stats["errors_checked"],
        n_files=stats["n_files"],
        n_suppressed=stats["n_suppressed"],
        n_baseline_matched=n_matched,
        baseline_size=baseline_size,
        contracts_path=path,
        updated=bool(update),
    )
