"""graftrace: the GL5xx static concurrency pack
(``hyperopt-tpu-torch-lint --trace``).

The serve/distributed stacks are threaded -- the continuous-batching
scheduler, the TCP front's handler threads, watchdog and heartbeat
workers, the ThreadTrials/SparkTrials dispatchers -- and the default
pack sees none of it: it checks single-threaded AST invariants.  This
pack proves LOCK DISCIPLINE with zero test execution.

The model, per class (single file, stdlib ``ast`` only):

1. **Lock discovery** -- ``self.<attr> = threading.Lock()/RLock()``
   and ``threading.Condition(...)``; a ``Condition(self._lock)`` is an
   ALIAS of its lock (acquiring either acquires the same mutex), so
   held-sets are tracked in canonical lock names.
2. **Held-set analysis** -- every statement's lexically held locks
   (``with self._lock:`` regions), then an inter-procedural fixpoint
   over the class's self-call graph: a private helper called only from
   guarded contexts inherits the intersection of its callers' held
   sets, while PUBLIC methods, dunders, and THREAD-ENTRY TARGETS
   (``threading.Thread(target=self._loop)`` / ``executor.submit`` /
   ``functools.partial(self._method, ...)`` -- resolved by the engine,
   :meth:`~.engine.FileContext._resolve_thread_targets`) are roots
   that enter with nothing held.
3. **Lock-domain inference** -- an attribute is guarded by lock L when
   it is WRITTEN under L somewhere and the strict majority (and at
   least two) of its accesses outside ``__init__`` hold L.

Nested function/lambda bodies are skipped (their execution context is
unknown -- a closure may run on any thread at any time); ``__init__``
is exempt from GL501 (pre-publication writes race nothing; GL506
covers the start-before-assigned hazard).  Heuristic by design, like
every graftlint rule: each checker's true-positive and near-miss
behavior is pinned by a fixture pair in ``tests/lint_fixtures/``, and
the runtime half -- the lockdep sanitizer (:mod:`.lockdep`) armed in
the serve suites -- catches the orders the AST cannot see.

Suppression is the standard pragma (``# graftlint: disable=GL503
reason``), and findings ride the same baseline machinery; the
committed GL5xx baseline is zero.
"""

from __future__ import annotations

import ast

from .engine import dotted_name, terminal_name, walk_scope

__all__ = ["TRACE_CHECKERS"]

TRACE_CHECKERS = []


def register(rule_id):
    def deco(fn):
        TRACE_CHECKERS.append((rule_id, fn))
        return fn

    return deco


_METHOD_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_NESTED_NODES = _METHOD_NODES + (ast.Lambda,)

#: factory terminals that make a self attribute a lock
_LOCK_FACTORIES = frozenset({"Lock", "RLock"})

#: container-mutating method names: ``self.x.append(...)`` is a WRITE
#: to the shared attribute for lock-domain inference, even though the
#: attribute node itself is a Load
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "remove", "clear", "add", "discard", "update", "setdefault", "sort",
})

#: factory terminals whose result is a dispatch callable: a call of the
#: attribute runs device work (``build_*_fn`` factories match by shape)
_DISPATCH_FACTORIES = frozenset({"compile", "make_graphed_callables"})

#: blocking-call terminals for GL503 (socket ops, durability barriers)
_SOCKET_BLOCKERS = frozenset({"accept", "connect", "recv", "recv_into",
                              "sendall"})

#: durable-state mutators (the WAL/snapshot protocol surface) -- both
#: GL503 (blocking fsync-class work under a lock) and GL507 (daemon
#: threads tearing them) key off this set
_DURABLE_CALLS = frozenset({
    "durable_pickle", "save_trials", "log_tell", "log_open",
    "log_served", "log_ask", "snapshot", "maybe_snapshot",
})


def _is_self_attr(node):
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    )


def _is_mutation(ctx, node):
    """``node`` (an Attribute ``self.X``) is a write: a Store/Del, a
    subscript-store through it, or a mutating method call on it."""
    if isinstance(node.ctx, (ast.Store, ast.Del)):
        return True
    p = ctx.parents.get(node)
    if (
        isinstance(p, ast.Subscript)
        and p.value is node
        and isinstance(p.ctx, (ast.Store, ast.Del))
    ):
        return True
    if isinstance(p, ast.Attribute) and p.value is node and (
        p.attr in _MUTATORS
    ):
        pp = ctx.parents.get(p)
        if isinstance(pp, ast.Call) and pp.func is p:
            return True
    return False


class _MethodScan:
    """One method's concurrency-relevant events, with lexical held-sets
    (canonical lock names) attached to each."""

    __slots__ = ("accesses", "calls", "acquires", "ext_calls", "waits")

    def __init__(self):
        self.accesses = []   # (attr, node, is_write, held)
        self.calls = []      # (method_name, node, held) -- self.m(...)
        self.acquires = []   # (lock_attr, with_node, held_before)
        self.ext_calls = []  # (call_node, held) -- every call
        self.waits = []      # (call_node, cond_attr, held)


class _ClassModel:
    """Lock discovery + held-set analysis for one ClassDef."""

    def __init__(self, ctx, cls):
        self.ctx = ctx
        self.cls = cls
        self.methods = {
            n.name: n for n in cls.body if isinstance(n, _METHOD_NODES)
        }
        self.locks = {}          # attr -> "Lock" | "RLock" | "Condition"
        self.cond_of = {}        # condition attr -> aliased lock attr
        self.dispatch_attrs = set()  # self.X = build_*_fn(...)/compile(...)
        self._collect_attrs()
        self.scans = {}
        self.entry = {}
        if self.locks:
            for name, m in self.methods.items():
                self.scans[name] = self._scan(m)
            self._solve_entry_held()

    # -- discovery ---------------------------------------------------------

    def _collect_attrs(self):
        for m in self.methods.values():
            for node in walk_scope(m):
                if not (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)):
                    continue
                t = terminal_name(node.value.func)
                for tgt in node.targets:
                    if not _is_self_attr(tgt):
                        continue
                    if t in _LOCK_FACTORIES:
                        self.locks[tgt.attr] = t
                    elif t == "Condition":
                        self.locks[tgt.attr] = "Condition"
                        args = node.value.args
                        if args and _is_self_attr(args[0]):
                            self.cond_of[tgt.attr] = args[0].attr
                    elif t is not None and (
                        t in _DISPATCH_FACTORIES
                        or (t.startswith("build_") and t.endswith("_fn"))
                    ):
                        self.dispatch_attrs.add(tgt.attr)

    def canon(self, attr):
        """Condition attrs alias the lock they were built over."""
        return self.cond_of.get(attr, attr)

    @property
    def lock_names(self):
        return {self.canon(a) for a in self.locks}

    def _lock_attr_of(self, expr):
        if _is_self_attr(expr) and expr.attr in self.locks:
            return self.canon(expr.attr)
        return None

    # -- per-method scan ---------------------------------------------------

    def _scan(self, method):
        sc = _MethodScan()

        def visit(node, held):
            if isinstance(node, _NESTED_NODES):
                return  # nested scope: execution context unknown
            if isinstance(node, ast.With):
                inner = held
                for item in node.items:
                    lock = self._lock_attr_of(item.context_expr)
                    if lock is not None:
                        sc.acquires.append((lock, node, inner))
                        inner = inner | {lock}
                    else:
                        visit(item.context_expr, held)
                    if item.optional_vars is not None:
                        visit(item.optional_vars, held)
                for st in node.body:
                    visit(st, inner)
                return
            if _is_self_attr(node):
                sc.accesses.append((
                    node.attr, node, _is_mutation(self.ctx, node), held,
                ))
            if isinstance(node, ast.Call):
                sc.ext_calls.append((node, held))
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and _is_self_attr(f)
                    and f.attr in self.methods
                ):
                    sc.calls.append((f.attr, node, held))
                if (
                    isinstance(f, ast.Attribute)
                    and f.attr == "wait"
                    and _is_self_attr(f.value)
                    and self.locks.get(f.value.attr) == "Condition"
                ):
                    sc.waits.append((node, f.value.attr, held))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for st in method.body:
            visit(st, frozenset())
        return sc

    # -- inter-procedural held-at-entry fixpoint ---------------------------

    def _solve_entry_held(self):
        """entry[m] = locks provably held whenever m runs: the
        intersection over its in-class call sites of (lexical held at
        the site | entry of the caller).  Public methods, dunders, and
        thread-entry targets are roots (entry = nothing held); so are
        private methods with no in-class call site (unknown callers)."""
        called = set()
        for sc in self.scans.values():
            for name, _node, _held in sc.calls:
                called.add(name)
        roots = set()
        for name, m in self.methods.items():
            is_private = name.startswith("_") and not name.startswith("__")
            if not is_private or m in self.ctx.thread_targets or (
                name not in called
            ):
                roots.add(name)
        TOP = frozenset(self.lock_names)
        self.entry = {
            name: (frozenset() if name in roots else TOP)
            for name in self.methods
        }
        for _ in range(len(self.methods) + 2):
            changed = False
            for caller, sc in self.scans.items():
                base = self.entry[caller]
                for callee, _node, held in sc.calls:
                    eff = held | base
                    cur = self.entry[callee]
                    new = cur & eff
                    if callee in roots:
                        new = frozenset()
                    if new != cur:
                        self.entry[callee] = new
                        changed = True
            if not changed:
                break

    def held(self, method_name, lexical):
        return lexical | self.entry[method_name]


def _models(ctx):
    """The file's lock-holding class models (memoized on the ctx)."""
    models = getattr(ctx, "_trace_models", None)
    if models is None:
        models = [
            _ClassModel(ctx, n)
            for n in ast.walk(ctx.tree)
            if isinstance(n, ast.ClassDef)
        ]
        ctx._trace_models = models
    return [m for m in models if m.locks]


# ---------------------------------------------------------------------------
# GL501 -- unguarded shared-attribute access
# ---------------------------------------------------------------------------


@register("GL501")
def check_unguarded_shared_attr(ctx):
    for model in _models(ctx):
        skip = (
            set(model.locks) | set(model.methods) | model.dispatch_attrs
        )
        per_attr = {}
        for name in model.methods:
            if name == "__init__":
                continue
            for attr, node, is_write, held in model.scans[name].accesses:
                if attr in skip:
                    continue
                eff = model.held(name, held)
                per_attr.setdefault(attr, []).append(
                    (name, node, is_write, eff)
                )
        for attr in sorted(per_attr):
            accs = per_attr[attr]
            for lock in sorted(model.lock_names):
                writes_under = any(
                    w and lock in eff for (_n, _nd, w, eff) in accs
                )
                if not writes_under:
                    continue
                n_under = sum(1 for (*_x, eff) in accs if lock in eff)
                n_out = len(accs) - n_under
                if n_under < 2 or n_under <= n_out:
                    continue
                for mname, node, is_write, eff in accs:
                    if lock not in eff:
                        verb = "mutated" if is_write else "read"
                        yield ctx.finding(
                            "GL501", node,
                            f"self.{attr} is guarded by self.{lock} "
                            "(written under it, and the majority of its "
                            f"accesses hold it) but is {verb} lock-free "
                            f"in {model.cls.name}.{mname} -- a data "
                            "race once any thread entry reaches here",
                        )
                break  # one inferred guard per attribute


# ---------------------------------------------------------------------------
# GL502 -- lock-order inversion
# ---------------------------------------------------------------------------


@register("GL502")
def check_lock_order_inversion(ctx):
    for model in _models(ctx):
        if len(model.lock_names) < 2:
            continue
        edges = {}  # (held_lock, acquired_lock) -> (method, with_node)
        for name in model.methods:
            for lock, node, held in model.scans[name].acquires:
                for h in model.held(name, held):
                    if h != lock and (h, lock) not in edges:
                        edges[(h, lock)] = (name, node)
        adj = {}
        for (a, b) in edges:
            adj.setdefault(a, set()).add(b)

        def reaches(src, dst):
            seen, stack = set(), [src]
            while stack:
                cur = stack.pop()
                if cur == dst:
                    return True
                if cur in seen:
                    continue
                seen.add(cur)
                stack.extend(adj.get(cur, ()))
            return False

        flagged = sorted(
            ((name, node, a, b)
             for (a, b), (name, node) in edges.items()
             if reaches(b, a)),
            key=lambda t: (t[1].lineno, t[1].col_offset),
        )
        for name, node, a, b in flagged:
            yield ctx.finding(
                "GL502", node,
                f"{model.cls.name}.{name} acquires self.{b} while "
                f"holding self.{a}, but self.{a} is also acquired "
                f"under self.{b} elsewhere in the class -- a lock-order "
                "cycle (ABBA deadlock once two threads interleave)",
            )


# ---------------------------------------------------------------------------
# GL503 -- blocking call while holding a lock
# ---------------------------------------------------------------------------


def _blocking_label(model, call):
    """A human label when ``call`` is a blocking primitive, else None."""
    func = call.func
    dn = dotted_name(func)
    if dn is not None:
        parts = dn.split(".")
        if parts[-1] == "sleep" and parts[0] in ("time", "_time"):
            return f"{dn}()"
    t = terminal_name(func)
    if t is None:
        return None
    if t in ("result", "join"):
        # thread-join / future-result arg shapes only: no positional
        # args, or a single numeric timeout (str.join / os.path.join
        # always pass non-numeric positionals)
        args_ok = not call.args or (
            len(call.args) == 1
            and isinstance(call.args[0], ast.Constant)
            and isinstance(call.args[0].value, (int, float))
        )
        if args_ok:
            owner = "Future.result" if t == "result" else "Thread.join"
            return f"{owner}()"
        return None
    if t in _SOCKET_BLOCKERS:
        return f"socket .{t}()"
    if t == "fsync":
        return "fsync()"
    if t in ("synchronize", "block_until_ready"):
        return f"device sync {t}()"
    if t in _DURABLE_CALLS:
        return f"durable write {t}()"
    if (
        isinstance(func, ast.Attribute)
        and _is_self_attr(func)
        and func.attr in model.dispatch_attrs
    ):
        return f"compiled dispatch self.{func.attr}()"
    return None


@register("GL503")
def check_blocking_call_under_lock(ctx):
    for model in _models(ctx):
        for name in model.methods:
            for node, held in model.scans[name].ext_calls:
                eff = model.held(name, held)
                if not eff:
                    continue
                label = _blocking_label(model, node)
                if label is None:
                    continue
                locks = ", ".join(f"self.{x}" for x in sorted(eff))
                yield ctx.finding(
                    "GL503", node,
                    f"{label} while holding {locks} "
                    f"({model.cls.name}.{name}): every thread "
                    "contending on the lock stalls for the call's full "
                    "latency -- move it outside the guarded region",
                )


# ---------------------------------------------------------------------------
# GL504 -- Condition.wait without an enclosing predicate while-loop
# ---------------------------------------------------------------------------


@register("GL504")
def check_wait_without_predicate_loop(ctx):
    for model in _models(ctx):
        for name, method in model.methods.items():
            for node, cond_attr, _held in model.scans[name].waits:
                in_while = False
                for anc in ctx.ancestors(node):
                    if isinstance(anc, ast.While):
                        in_while = True
                        break
                    if anc is method:
                        break
                if not in_while:
                    yield ctx.finding(
                        "GL504", node,
                        f"self.{cond_attr}.wait() outside a while loop "
                        f"({model.cls.name}.{name}): spurious wakeups "
                        "and stolen predicates make if-then-wait lose "
                        "the signal -- re-check the predicate in a "
                        "while",
                    )


# ---------------------------------------------------------------------------
# GL505 -- Future resolved while holding a lock
# ---------------------------------------------------------------------------


@register("GL505")
def check_future_resolved_under_lock(ctx):
    for model in _models(ctx):
        for name in model.methods:
            for node, held in model.scans[name].ext_calls:
                eff = model.held(name, held)
                if not eff:
                    continue
                t = terminal_name(node.func)
                if t not in ("set_result", "set_exception"):
                    continue
                locks = ", ".join(f"self.{x}" for x in sorted(eff))
                yield ctx.finding(
                    "GL505", node,
                    f".{t}() while holding {locks} "
                    f"({model.cls.name}.{name}): done-callbacks run "
                    "inline in the resolving thread and can re-enter "
                    "the lock (callback-under-lock deadlock); collect "
                    "futures under the lock, resolve after release",
                )


# ---------------------------------------------------------------------------
# GL506 -- thread started in __init__ before attributes are assigned
# ---------------------------------------------------------------------------


@register("GL506")
def check_thread_started_in_init(ctx):
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        init = next(
            (n for n in cls.body
             if isinstance(n, _METHOD_NODES) and n.name == "__init__"),
            None,
        )
        if init is None:
            continue
        own = list(walk_scope(init))
        thread_names, thread_attrs = set(), set()
        for n in own:
            if not (isinstance(n, ast.Assign)
                    and isinstance(n.value, ast.Call)
                    and terminal_name(n.value.func) == "Thread"):
                continue
            for tgt in n.targets:
                if isinstance(tgt, ast.Name):
                    thread_names.add(tgt.id)
                elif _is_self_attr(tgt):
                    thread_attrs.add(tgt.attr)
        starts = []
        for n in own:
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "start"):
                continue
            recv = n.func.value
            if (
                (isinstance(recv, ast.Name) and recv.id in thread_names)
                or (_is_self_attr(recv) and recv.attr in thread_attrs)
                or (isinstance(recv, ast.Call)
                    and terminal_name(recv.func) == "Thread")
            ):
                starts.append(n)
        if not starts:
            continue
        attr_assign_lines = [
            n.lineno
            for n in own
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))
            for tgt in (
                n.targets if isinstance(n, ast.Assign) else [n.target]
            )
            if _is_self_attr(tgt) and tgt.attr not in thread_attrs
        ]
        for node in starts:
            later = [l for l in attr_assign_lines if l > node.lineno]
            if later:
                yield ctx.finding(
                    "GL506", node,
                    f"thread started in {cls.name}.__init__ before the "
                    f"instance attribute assignment(s) at line(s) "
                    f"{sorted(later)}: the target thread can observe a "
                    "partially constructed object -- assign everything "
                    "first, start last (or start() explicitly)",
                )


# ---------------------------------------------------------------------------
# GL507 -- daemon thread mutating WAL/checkpoint durable state
# ---------------------------------------------------------------------------


@register("GL507")
def check_daemon_durable_mutation(ctx):
    seen_nodes = set()
    for fn, info in sorted(
        ctx.thread_targets.items(), key=lambda kv: kv[0].lineno
    ):
        if not info.get("daemon"):
            continue
        # the daemon entry plus its transitive same-class self-callees
        cls = None
        for a in ctx.ancestors(fn):
            if isinstance(a, ast.ClassDef):
                cls = a
                break
        methods = (
            {n.name: n for n in cls.body if isinstance(n, _METHOD_NODES)}
            if cls is not None else {}
        )
        scopes, queue, visited = [], [fn], set()
        while queue:
            cur = queue.pop()
            if cur in visited:
                continue
            visited.add(cur)
            scopes.append(cur)
            for n in walk_scope(cur):
                if (
                    isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and _is_self_attr(n.func)
                    and n.func.attr in methods
                ):
                    queue.append(methods[n.func.attr])
        entry = getattr(fn, "name", "<lambda>")
        for scope in scopes:
            for n in walk_scope(scope):
                if not isinstance(n, ast.Call):
                    continue
                t = terminal_name(n.func)
                if t in _DURABLE_CALLS and n not in seen_nodes:
                    seen_nodes.add(n)
                    yield ctx.finding(
                        "GL507", n,
                        f"durable write {t}() is reachable from daemon "
                        f"thread entry {entry!r}: a daemon thread dies "
                        "mid-write at interpreter exit, tearing "
                        "WAL/checkpoint state -- use a joined worker, "
                        "or suppress with the recovery argument",
                    )
