"""The graftlint rule pack: the port's capture discipline (GL1xx),
dispatch hygiene (GL2xx), durability and fault-routing (GL3xx)
invariants as AST checks, plus the rule table of the program-contract
(GL4xx, :mod:`.ir`), concurrency (GL5xx, :mod:`.trace`) and wire
(GL6xx, :mod:`.wire`) packs.

Every checker is a function ``check(ctx) -> iterable[Finding]`` over a
:class:`~.engine.FileContext`; registration order is reporting order.
Rules are heuristic by design -- lexical, single-file, no type
inference -- and every rule's true-positive and near-miss behavior is
pinned by a fixture pair in ``tests/lint_fixtures/`` (GL1xx/GL2xx:
``tests/lint_fixtures_torch/``, torch twins of the reference's JAX
pairs).  GL1xx/GL2xx read "captured scope" where the reference read
"jitted scope" (:class:`~.engine.FileContext`'s ``captured``).  Where a rule
names a seam (the durable savers of ``utils/checkpoint.py``,
``distributed/_common.with_retries``, the ``obs/registry.py`` metric
registry) it is this package's twin of the same name.
"""

from __future__ import annotations

import ast
import dataclasses

import re

from .engine import CAPTURE_CALLS, dotted_name, terminal_name, walk_scope

__all__ = ["RULES", "CHECKERS", "Rule"]


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    summary: str


RULES = {}
CHECKERS = []


def register(rule_id, name, summary):
    RULES[rule_id] = Rule(rule_id, name, summary)

    def deco(fn):
        CHECKERS.append((rule_id, fn))
        return fn

    return deco


# engine-emitted rules: registered so pragmas naming them validate and
# --list-rules documents them, but no checker walks the tree
RULES["GL001"] = Rule(
    "GL001", "unknown-pragma-rule",
    "a # graftlint: disable= pragma names a rule ID the pack does not define",
)
RULES["GL002"] = Rule(
    "GL002", "parse-error", "file does not parse (syntax error)"
)

# GL4xx -- the program-contract pack (hyperopt-tpu-torch-lint --ir):
# checked over the TRACED aten graphs of registered programs, not the
# AST, so no checker here walks a tree (see analysis/ir.py; the rule
# metadata lives in this table so --list-rules and pragma validation
# cover the whole pack without importing torch)
for _id, _name, _summary in (
    ("GL401", "ir-host-sync",
     "a host read (Tensor.item/tolist/numpy/cpu, a tensor's truth value, "
     "torch.cuda.synchronize) or an aten._local_scalar_dense/nonzero "
     "node inside a registered program"),
    ("GL402", "ir-f64-promotion",
     "a float64/complex128 node appears when the program is traced "
     "under torch.set_default_dtype(torch.float64) (an un-dtyped "
     "factory widening silently)"),
    ("GL403", "ir-mutation-contract",
     "the inputs a registered program mutates in place differ from the "
     "static carry its registration declares"),
    ("GL404", "ir-oversized-constant",
     "a closed-over tensor constant >= the byte threshold is baked into "
     "the traced program"),
    ("GL405", "ir-mid-program-transfer",
     "a device transfer (.to(device), .cuda(), .cpu()) inside the "
     "program body"),
    ("GL406", "ir-contract-drift",
     "output shapes/dtypes, mutated inputs, allowed syncs, aten node "
     "count, FLOPs or constant bytes drifted from the committed "
     "analysis/program_contracts.json"),
):
    RULES[_id] = Rule(_id, _name, _summary)

# GL5xx -- the graftrace concurrency pack (hyperopt-tpu-torch-lint --trace):
# static lock-discipline and race analysis over the serve/distributed
# threaded surface.  The checkers live in analysis/trace.py (their own
# pack, selected by lint_source(pack="trace")); the metadata lives in
# this table so --list-rules documents them and pragmas naming them
# validate under the default pack (GL001 must not flag a GL5xx
# suppression on a scheduler line as unknown).
for _id, _name, _summary in (
    ("GL501", "unguarded-shared-attribute",
     "a shared instance attribute written under the class's inferred "
     "lock domain (majority `with self._lock:` usage) is read or "
     "mutated lock-free elsewhere -- a data race across methods or "
     "thread-entry targets"),
    ("GL502", "lock-order-inversion",
     "two locks of one class are acquired in both orders across its "
     "methods (inter-procedural acquisition graph over the class and "
     "its self-callees has a cycle) -- the classic ABBA deadlock"),
    ("GL503", "blocking-call-under-lock",
     "a blocking call (socket accept/recv/sendall, fsync/durable "
     "writes, Future.result/Thread.join, time.sleep, or a compiled "
     "dispatch callable) runs while a lock is held -- every contending "
     "thread stalls for the call's full latency"),
    ("GL504", "condition-wait-without-predicate-loop",
     "Condition.wait called outside an enclosing while loop -- spurious "
     "wakeups and stolen predicates make if-then-wait lose signals"),
    ("GL505", "future-resolved-under-lock",
     "Future.set_result/set_exception while holding a lock -- done-"
     "callbacks run inline in the resolving thread and can re-enter "
     "the lock (the callback-under-lock deadlock shape)"),
    ("GL506", "thread-started-before-init-complete",
     "a thread is started inside __init__ before later instance "
     "attributes are assigned -- the target can observe a partially "
     "constructed object"),
    ("GL507", "daemon-thread-durable-mutation",
     "WAL/checkpoint durable state is mutated from a daemon-thread "
     "entry point (directly or via same-class callees) -- daemon "
     "threads die mid-write at interpreter exit, tearing the artifact"),
):
    RULES[_id] = Rule(_id, _name, _summary)

# graftwire (GL6xx) rules run via analysis/wire.py over the wire-
# protocol and fault surfaces (service/router dispatch, client call
# sites, typed-error mapping, crash-point registries), selected by
# `hyperopt-tpu-torch-lint --wire`.  Same registration posture as
# GL5xx: metadata-only rows so --list-rules and GL001 pragma
# validation cover the pack.
for _id, _name, _summary in (
    ("GL601", "wire-op-asymmetry",
     "a client-sent op has no server handler, a handled op has no "
     "client or test caller, or a global op one front handles the "
     "other silently refuses untyped"),
    ("GL602", "wire-contract-drift",
     "an op's extracted reply-field set drifted from the committed "
     "wire_contracts.json (accept deliberate changes with --wire "
     "--update-contracts)"),
    ("GL603", "unmapped-serve-error",
     "a ServeError subclass never appears at the client reply seam "
     "(_REPLY_ERRORS) -- the wire error would surface as a generic "
     "RuntimeError instead of its typed exception"),
    ("GL604", "dead-crash-point",
     "a name registered in a *_CRASH_POINTS tuple is never armed or "
     "iterated by any test -- an untested crash window"),
    ("GL605", "durable-seam-without-crash-point",
     "a durable write seam (fsync/rename/WAL append) in serve// "
     "distributed/ has no crashpoint() in its function scope -- the "
     "torn-state window is uninjectable"),
    ("GL606", "retry-after-without-cap",
     "a retry_after-carrying reply is built from a bare numeric "
     "without the RETRY_AFTER_CAP/jitter path -- clients can be told "
     "to back off unboundedly"),
):
    RULES[_id] = Rule(_id, _name, _summary)


def _is_test_file(ctx):
    base = ctx.parts[-1] if ctx.parts else ""
    return base.startswith("test_") or base == "conftest.py"


_NUMPY_MODULES = frozenset({"np", "numpy", "onp"})


def _call_args_all_constant(call):
    return all(isinstance(a, ast.Constant) for a in call.args)


# ---------------------------------------------------------------------------
# GL1xx -- capture discipline: what a captured CUDA graph cannot hold
# ---------------------------------------------------------------------------

_HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_HOST_MATERIALIZERS = frozenset({"asarray", "array"})
_SCALAR_BUILTINS = frozenset({"float", "int", "bool"})
_BUILD_FN = re.compile(r"^build_\w*_fn$")


def _is_cuda_synchronize(call):
    dn = dotted_name(call.func) or ""
    return dn == "torch.cuda.synchronize" or dn == "cuda.synchronize"


@register(
    "GL101", "capture-host-sync",
    ".item()/.tolist()/.cpu()/.numpy(), float()/int()/bool() of a "
    "non-literal, np.asarray/np.array, nonzero or torch.cuda.synchronize "
    "inside a captured step -- a host read that breaks capture, or runs "
    "once at capture and is baked into every replay",
)
def check_capture_host_sync(ctx):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute):
            dn = dotted_name(func)
            if func.attr in _HOST_SYNC_METHODS and not node.args:
                what = f".{func.attr}()"
            elif func.attr == "nonzero":
                what = f"{dn}()" if dn and dn.startswith("torch.") else ".nonzero()"
            elif (
                func.attr in _HOST_MATERIALIZERS
                and dn is not None
                and dn.split(".")[0] in _NUMPY_MODULES
            ):
                what = f"{dn}()"
            elif _is_cuda_synchronize(node):
                what = "torch.cuda.synchronize()"
            else:
                continue
        elif (
            isinstance(func, ast.Name)
            and func.id in _SCALAR_BUILTINS
            and node.args
            and not _call_args_all_constant(node)
        ):
            what = f"{func.id}()"
        else:
            continue
        if ctx.in_captured_scope(node):
            yield ctx.finding(
                "GL101", node,
                f"{what} inside a captured step reads the card from the "
                "host: capture breaks, or the value read at capture is "
                "baked into every replay; keep it on the card and read it "
                "after the replay",
            )


@register(
    "GL102", "print-in-capture",
    "print/breakpoint inside a captured step -- it runs once, at "
    "capture, and never on replay",
)
def check_capture_print(ctx):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dn = dotted_name(node.func)
        if dn in ("print", "breakpoint", "pdb.set_trace") and (
            ctx.in_captured_scope(node)
        ):
            yield ctx.finding(
                "GL102", node,
                f"{dn}() inside a captured step runs once at capture and "
                "never on replay; print outside the graph",
            )


@register(
    "GL103", "loop-var-capture-closure",
    "a captured step defined inside a loop closes over the loop "
    "variable -- every graph bakes the value the variable held at "
    "capture",
)
def check_capture_loop_closure(ctx):
    # the steps themselves, not the lambdas a step defines and applies
    # within one capture; and only loops of host code, outside capture
    for fn in ctx.captured:
        # names (re)bound by For/While loops that lexically enclose fn
        loop_names = set()
        for anc in ctx.ancestors(fn):
            if isinstance(anc, (ast.For, ast.While)) and not ctx.in_captured_scope(anc):
                for t in ast.walk(getattr(anc, "target", anc)):
                    if isinstance(t, ast.Name):
                        loop_names.add(t.id)
                for st in walk_scope(anc):
                    if isinstance(st, ast.Name) and isinstance(st.ctx, ast.Store):
                        loop_names.add(st.id)
        if not loop_names:
            continue
        args = fn.args
        local = {
            a.arg for a in (
                args.args + args.posonlyargs + args.kwonlyargs
                + ([args.vararg] if args.vararg else [])
                + ([args.kwarg] if args.kwarg else [])
            )
        }
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for st in body:
            for n in ast.walk(st):
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                    local.add(n.id)
        for st in body:
            for n in ast.walk(st):
                if (
                    isinstance(n, ast.Name)
                    and isinstance(n.ctx, ast.Load)
                    and n.id in loop_names
                    and n.id not in local
                ):
                    yield ctx.finding(
                        "GL103", n,
                        f"captured step closes over loop-carried {n.id!r}: "
                        "each graph holds the value of its capture; pass it "
                        "in a static tensor or bind it as a default",
                    )


def _is_program_construction(call):
    t = terminal_name(call.func)
    return t in ("capture_graph", "CUDAGraph", "make_graphed_callables") or bool(
        t and _BUILD_FN.match(t)
    )


@register(
    "GL104", "capture-in-loop",
    "capture_graph/torch.cuda.CUDAGraph()/build_*_fn(...) inside a loop "
    "-- a fresh graph or program per iteration; build it once or route "
    "through ops/compile.py's caches",
)
def check_capture_in_loop(ctx):
    if "compile.py" == (ctx.parts[-1] if ctx.parts else ""):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and _is_program_construction(node)):
            continue
        # the loop must enclose the call within the same function: a
        # def inside a loop capturing at ITS top level is regime GL103
        for anc in ctx.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                break
            if isinstance(anc, (ast.For, ast.While)):
                yield ctx.finding(
                    "GL104", node,
                    "graph or program constructed inside a loop: every "
                    "iteration captures or builds it again; hoist it or "
                    "use ops/compile.py's cache",
                )
                break


# ---------------------------------------------------------------------------
# GL2xx -- dispatch hygiene: static buffers, syncs, one build per program
# ---------------------------------------------------------------------------

#: tensor methods whose result shares the receiver's memory
_VIEW_METHODS = frozenset({
    "view", "view_as", "reshape", "expand", "expand_as", "squeeze",
    "unsqueeze", "select", "narrow", "unbind", "split", "chunk",
    "transpose", "permute", "movedim", "detach", "flatten", "t",
    "diagonal", "as_strided", "unflatten",
})


def _alias_root(expr):
    """The dotted name whose memory ``expr`` aliases (through
    subscripts and view methods), or None."""
    while True:
        if isinstance(expr, ast.Subscript):
            expr = expr.value
        elif (
            isinstance(expr, ast.Call)
            and isinstance(expr.func, ast.Attribute)
            and expr.func.attr in _VIEW_METHODS
        ):
            expr = expr.func.value
        else:
            return dotted_name(expr)


def _static_buffers(ctx):
    """Names and ``self.`` chains a replay writes: the names stored
    inside a ``with torch.cuda.graph`` body (its static outputs), and the
    free names and ``self.`` chains a captured function writes in place
    (``x.copy_(...)``, ``x.index_copy_(...)``, ``x[i] = ...``: its
    static carry)."""
    out = set()
    for block in ctx.graph_blocks:
        for st in block.body:
            for n in [st, *walk_scope(st)]:
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                    out.add(n.id)
    for fn in ctx.captured:
        args = fn.args
        local = {a.arg for a in args.args + args.posonlyargs + args.kwonlyargs}
        own = list(walk_scope(fn))
        local |= {n.id for n in own
                  if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}
        for n in own:
            root = None
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr.endswith("_")
                and not n.func.attr.startswith("_")
            ):
                root = _alias_root(n.func.value)
            elif isinstance(n, (ast.Assign, ast.AugAssign)):
                tgts = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in tgts:
                    if isinstance(t, ast.Subscript):
                        root = _alias_root(t)
            if root and (root.startswith("self.") or root.split(".")[0] not in local):
                out.add(root)
    return out


def _is_replay(node):
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "replay"
        and not node.args
    )


@register(
    "GL201", "read-after-replay",
    "a name bound to a captured graph's static output (or to a static "
    "carry tensor) is read after a later replay() without .clone() -- "
    "the replay overwrote its memory",
)
def check_read_after_replay(ctx):
    has_replay = any(_is_replay(n) for n in ast.walk(ctx.tree))
    if not has_replay:
        return
    static = _static_buffers(ctx)
    if not static:
        return

    def is_static(root):
        return root is not None and (
            root in static or any(root.startswith(s + ".") for s in static)
        )

    def _stmt_end(n):
        cur = n
        while cur is not None and not isinstance(cur, ast.stmt):
            cur = ctx.parents.get(cur)
        if cur is not None and getattr(cur, "end_lineno", None) is not None:
            return (cur.end_lineno, cur.end_col_offset, 1)
        return (n.lineno, n.col_offset, 1)

    for scope in list(ctx.functions) + [ctx.tree]:
        nodes = [n for n in walk_scope(scope) if hasattr(n, "lineno")]
        if not any(_is_replay(n) for n in nodes):
            continue
        events = []
        for n in nodes:
            if isinstance(n, ast.Assign):
                names = []
                for t in n.targets:
                    elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                    names.extend(e.id for e in elts if isinstance(e, ast.Name))
                events.append((_stmt_end(n), "bind", (names, is_static(_alias_root(n.value)))))
            elif _is_replay(n):
                events.append(((n.end_lineno, n.end_col_offset, 0), "replay", None))
            elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
                parent = ctx.parents.get(n)
                if isinstance(parent, ast.Attribute) and parent.attr == "replay":
                    continue
                events.append(((n.lineno, n.col_offset, 0), "load", n))
        bound, stale = set(), set()
        for _, kind, what in sorted(events, key=lambda e: e[0]):
            if kind == "bind":
                names, alias = what
                for name in names:
                    stale.discard(name)
                    (bound.add if alias else bound.discard)(name)
            elif kind == "replay":
                stale |= bound
            elif what.id in stale:
                yield ctx.finding(
                    "GL201", what,
                    f"{what.id!r} aliases a static buffer of a captured "
                    "graph and a replay() since overwrote it; .clone() it "
                    "before the replay",
                )
                stale.discard(what.id)
                bound.discard(what.id)  # one finding per binding


@register(
    "GL202", "sync-outside-bench",
    "torch.cuda.synchronize / Event.synchronize / Stream.synchronize "
    "outside bench/profiling modules -- product paths must stay "
    "launch-async",
)
def check_synchronize(ctx):
    name = ctx.parts[-1] if ctx.parts else ""
    if "bench" in name or "profiling" in name or _is_test_file(ctx):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and terminal_name(node.func) == "synchronize":
            yield ctx.finding(
                "GL202", node,
                "synchronize in a product path holds the host until the "
                "card drains; only bench/profiling code may sync (a host "
                "read of the result syncs on its own)",
            )


@register(
    "GL203", "per-call-capture",
    "capture_graph(f, dev).replay() or build_*_fn(...)(args) in one "
    "expression -- a fresh graph or program per call",
)
def check_per_call_capture(ctx):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        inner = node.func
        if _is_replay(node) and isinstance(inner.value, ast.Call) and (
            terminal_name(inner.value.func) in CAPTURE_CALLS
        ):
            what = "capture-then-replay"
        elif isinstance(inner, ast.Call) and _is_program_construction(inner):
            what = "build-then-call"
        else:
            continue
        yield ctx.finding(
            "GL203", node,
            f"{what} in one expression builds a fresh program per "
            "invocation; bind the graph or program once and reuse it",
        )


# ---------------------------------------------------------------------------
# GL3xx -- crash consistency & fault routing (the durability contract)
# ---------------------------------------------------------------------------

_WRITE_MODES = "wax+"


def _is_write_open(call):
    if terminal_name(call.func) != "open":
        return False
    mode = None
    if len(call.args) >= 2 and isinstance(call.args[1], ast.Constant):
        mode = call.args[1].value
    for kw in call.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = kw.value.value
    return isinstance(mode, str) and any(c in mode for c in _WRITE_MODES)


@register(
    "GL301", "rename-without-fsync",
    "os.rename/os.replace publishes a file written in the same function "
    "with no fsync -- a crash can publish an empty or truncated file",
)
def check_rename_without_fsync(ctx):
    for fn in ctx.functions:
        if isinstance(fn, ast.Lambda):
            continue
        own = list(walk_scope(fn))
        wrote = any(isinstance(n, ast.Call) and _is_write_open(n) for n in own)
        if not wrote:
            continue
        synced = any(
            isinstance(n, ast.Call) and terminal_name(n.func) == "fsync"
            for n in own
        )
        if synced:
            continue
        for n in own:
            if isinstance(n, ast.Call) and terminal_name(n.func) in (
                "rename", "replace"
            ):
                yield ctx.finding(
                    "GL301", n,
                    "rename publishes a file this function wrote without "
                    "fsync: the rename's metadata can reach disk before "
                    "the data does (fsync-before-rename)",
                )


# broad = a net wide enough to catch OSError/TransientBackendError by
# accident; a typed `except OSError` is a deliberate protocol catch
_BROAD_EXCEPTS = frozenset({"Exception", "BaseException"})


def _handler_is_broad(handler):
    if handler.type is None:
        return True
    types = (
        handler.type.elts
        if isinstance(handler.type, ast.Tuple)
        else [handler.type]
    )
    return any(terminal_name(t) in _BROAD_EXCEPTS for t in types)


@register(
    "GL302", "swallowed-broad-except",
    "broad except in the fault domain (distributed/, checkpoint) that "
    "neither re-raises nor consults is_transient -- can eat "
    "TransientBackendError/OSError meant for with_retries",
)
def check_swallowed_broad_except(ctx):
    in_domain = "distributed" in ctx.parts or (
        ctx.parts and ctx.parts[-1] == "checkpoint.py"
    )
    if not in_domain or _is_test_file(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _handler_is_broad(node):
            continue
        consults = False
        for n in [x for st in node.body for x in ast.walk(st)]:
            if isinstance(n, ast.Raise):
                consults = True
                break
            if isinstance(n, ast.Call) and terminal_name(n.func) in (
                "is_transient", "classify",
            ):
                consults = True
                break
        if not consults:
            yield ctx.finding(
                "GL302", node,
                "broad except swallows the error class with_retries "
                "routes on; catch typed, re-raise, or consult "
                "is_transient (suppress with a reason if deliberate)",
            )


@register(
    "GL303", "sleep-in-retry-loop",
    "time.sleep inside an except handler inside a loop -- a hand-rolled "
    "retry loop; route through _common.with_retries",
)
def check_sleep_in_retry_loop(ctx):
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if dotted_name(node.func) != "time.sleep":
            continue
        in_handler = in_loop = False
        for anc in ctx.ancestors(node):
            if isinstance(anc, ast.ExceptHandler):
                in_handler = True
            if isinstance(anc, (ast.For, ast.While)):
                in_loop = True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break
        if in_handler and in_loop:
            yield ctx.finding(
                "GL303", node,
                "sleep-on-error inside a loop is a hand-rolled retry: "
                "use _common.with_retries (bounded, classified backoff)",
            )


#: state-serialization entry points whose output, written straight to a
#: file, is a checkpoint in the making
_STATE_DUMPERS = frozenset({"dump", "savez", "savez_compressed"})


def _is_state_dump(call):
    """pickle.dump / np.savez / np.savez_compressed / torch.save with
    arguments."""
    dn = dotted_name(call.func)
    if dn is None or not call.args:
        return False
    if dn == "torch.save":
        return True
    parts = dn.split(".")
    if len(parts) != 2 or parts[1] not in _STATE_DUMPERS:
        return False
    return parts[0] == "pickle" or parts[0] in _NUMPY_MODULES


@register(
    "GL305", "state-dump-bypasses-durable-saver",
    "pickle.dump/np.savez/torch.save writes state to a file with no "
    "fsync in the "
    "same function -- a crash publishes a truncated checkpoint; route "
    "through utils/checkpoint's durable savers (tmp+fsync+rename)",
)
def check_state_dump_bypasses_durable_saver(ctx):
    # the gap GL301 cannot see: a checkpoint written IN PLACE (no
    # rename at all, so GL301 never fires) is still torn by a crash
    # mid-dump -- a trials pickle rewritten in place is the shape
    if _is_test_file(ctx):
        return
    for scope in list(ctx.functions) + [ctx.tree]:
        if isinstance(scope, ast.Lambda):
            continue
        own = list(walk_scope(scope))
        dumps = [
            n for n in own if isinstance(n, ast.Call) and _is_state_dump(n)
        ]
        if not dumps:
            continue
        names = {
            terminal_name(n.func)
            for n in own
            if isinstance(n, ast.Call)
        }
        if "fsync" in names:
            continue  # durable-saver shape; rename ordering is GL301's job
        if "BytesIO" in names:
            continue  # in-memory serialization: nothing to make durable
        for n in dumps:
            yield ctx.finding(
                "GL305", n,
                f"{dotted_name(n.func)}() writes state with no fsync "
                "in scope: a crash mid-write (or before writeback) "
                "publishes a truncated checkpoint; use the durable "
                "savers in utils/checkpoint.py",
            )


#: method names that mark a class as a LONG-LIVED service object (it
#: runs/serves/pumps for the process lifetime, so per-event growth is a
#: leak, not a working buffer)
_SERVICE_METHODS = frozenset({
    "start", "stop", "step", "serve_forever", "pump", "shutdown",
    "drain", "_loop", "loop", "run_forever",
})

#: calls on the attribute that bound its growth
_BOUNDING_CALLS = frozenset({"pop", "popleft", "clear", "remove"})


def _self_attr(node, attrs):
    """``node`` is ``self.<attr>`` for an attr in ``attrs``?"""
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and node.attr in attrs
    )


@register(
    "GL306", "unbounded-append-on-service-object",
    "a plain-list attribute of a long-lived service class grows by "
    "append with no bounding operation anywhere in the class -- a slow "
    "per-event leak; use a maxlen deque or trim it",
)
def check_unbounded_service_append(ctx):
    # the leak class of a scheduler whose per-ask latency list grew one
    # entry per ask forever (a maxlen ring buffer bounds it).  A
    # heuristic single-class dataflow: list attrs born in __init__,
    # appended to by the service's methods, never popped/cleared/
    # trimmed/rebound anywhere in the class.
    if _is_test_file(ctx):
        return
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        if not (_SERVICE_METHODS & set(methods)):
            continue
        init = methods.get("__init__")
        if init is None:
            continue
        list_attrs = {
            t.attr
            for node in ast.walk(init)
            if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.List)
            for t in node.targets
            if isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
        }
        if not list_attrs:
            continue
        appends, bounded = {}, set()
        for name, fn in methods.items():
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and _self_attr(node.func.value, list_attrs)
                ):
                    attr = node.func.value.attr
                    if node.func.attr == "append" and name != "__init__":
                        appends.setdefault(attr, []).append(node)
                    elif node.func.attr in _BOUNDING_CALLS:
                        bounded.add(attr)
                elif isinstance(node, ast.Delete):
                    for t in node.targets:
                        tv = getattr(t, "value", None)
                        if isinstance(t, ast.Subscript) and _self_attr(
                            tv, list_attrs
                        ):
                            bounded.add(tv.attr)
                elif isinstance(node, ast.Assign) and name != "__init__":
                    for t in node.targets:
                        if _self_attr(t, list_attrs):
                            bounded.add(t.attr)  # rebound (swap/reset)
                        tv = getattr(t, "value", None)
                        if isinstance(t, ast.Subscript) and _self_attr(
                            tv, list_attrs
                        ):
                            bounded.add(tv.attr)  # slice trim
        for attr, nodes in appends.items():
            if attr in bounded:
                continue
            for node in nodes:
                yield ctx.finding(
                    "GL306", node,
                    f"self.{attr} grows by append on long-lived service "
                    f"class {cls.name} with no pop/clear/trim/rebind in "
                    "the class: a per-event leak on a process that "
                    "serves forever -- use collections.deque(maxlen=...)"
                    " or trim it",
                )


# the call names that mark a timing delta as ALREADY landing on a
# graftscope sink (Histogram.observe / ring append / Recorder.record /
# the *_since helpers): the delta is computed en route to the registry,
# which is the sanctioned place for it
_METRIC_SINKS = frozenset({
    "observe", "observe_since", "append", "record", "event",
    "set_duration_ms",
})

_TIME_SOURCES = frozenset({"time.time", "time.perf_counter"})

#: graftscope's own internals: the one place timing math and raw
#: accumulator attributes are the implementation, not ad-hoc state
_OBS_INTERNALS = frozenset({"registry.py", "flightrec.py"})

#: class-body descriptor factories that register an attribute on the
#: graftscope registry -- an attr declared this way is the MIGRATED
#: idiom GL307 exists to steer toward
_REGISTRY_DESCRIPTORS = frozenset({
    "CounterAttr", "GaugeAttr", "HistogramAttr",
})


def _feeds_metric_sink(ctx, node):
    """Is this expression an argument of a ``.observe(...)``-style
    call (directly or via an enclosing expression)?"""
    for anc in ctx.ancestors(node):
        if isinstance(anc, ast.stmt):
            return False
        if (
            isinstance(anc, ast.Call)
            and isinstance(anc.func, ast.Attribute)
            and anc.func.attr in _METRIC_SINKS
        ):
            return True
    return False


@register(
    "GL307", "ad-hoc-metric-state",
    "timing deltas (time.time()/perf_counter() subtraction) or public "
    "counter attributes accumulated outside the graftscope registry in "
    "serve//obs//distributed/ library code -- operational signals must "
    "live on the typed, bounded, scrapeable registry",
)
def check_adhoc_metric_state(ctx):
    in_domain = any(
        p in ("serve", "obs", "distributed") for p in ctx.parts[:-1]
    )
    if not in_domain or _is_test_file(ctx):
        return
    base = ctx.parts[-1] if ctx.parts else ""
    if "obs" in ctx.parts[:-1] and base in _OBS_INTERNALS:
        return
    # (a) inline timing deltas: a minus with a direct time.time()/
    # perf_counter() operand that is NOT en route to a registry sink
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)):
            continue
        for side in (node.left, node.right):
            if (
                isinstance(side, ast.Call)
                and dotted_name(side.func) in _TIME_SOURCES
                and not _feeds_metric_sink(ctx, node)
            ):
                yield ctx.finding(
                    "GL307", node,
                    f"ad-hoc {dotted_name(side.func)}() delta in library "
                    "code: land it on the graftscope registry "
                    "(Histogram.observe_since / Gauge.set_duration_ms) "
                    "so it is bounded, typed, and scrapeable",
                )
                break
    # (b) public numeric counter attrs (born as a literal in __init__)
    # accumulated by +=/-= in methods, with no registry descriptor of
    # that name on the class -- the pre-graftscope counter idiom
    for cls in ast.walk(ctx.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        descriptor_attrs = {
            t.id
            for node in cls.body
            if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and terminal_name(node.value.func) in _REGISTRY_DESCRIPTORS
            for t in node.targets
            if isinstance(t, ast.Name)
        }
        methods = {
            n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        init = methods.get("__init__")
        if init is None:
            continue
        counter_attrs = {
            t.attr
            for node in ast.walk(init)
            if isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, (int, float))
            and not isinstance(node.value.value, bool)
            for t in node.targets
            if isinstance(t, ast.Attribute)
            and isinstance(t.value, ast.Name)
            and t.value.id == "self"
            and not t.attr.startswith("_")
        } - descriptor_attrs
        if not counter_attrs:
            continue
        for name, fn in methods.items():
            if name == "__init__":
                continue
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.AugAssign)
                    and isinstance(node.op, (ast.Add, ast.Sub))
                    and _self_attr(node.target, counter_attrs)
                ):
                    yield ctx.finding(
                        "GL307", node,
                        f"self.{node.target.attr} is a hand-rolled "
                        f"counter on {cls.name}: declare it as a "
                        "graftscope CounterAttr/GaugeAttr so the "
                        "total is typed, labeled, and scrapeable",
                    )


#: the durability calls whose per-item cost group-commit amortizes: a
#: raw fsync and the durable-pickle saver (tmp+fsync+rename) -- one of
#: these per loop iteration is one storage barrier per item
_SYNC_CALLS = frozenset({"fsync", "durable_pickle"})


@register(
    "GL308", "fsync-in-hot-loop",
    "fsync/durable_pickle issued inside a for-loop in serve//"
    "distributed/ library code -- one storage barrier per item is the "
    "latency class group-commit retired (flush-then-barrier, "
    "graftburst round barriers); flush per item, fsync ONCE after the "
    "loop (barrier helpers are exempt by name)",
)
def check_fsync_in_hot_loop(ctx):
    # the graftburst rule: a tell/round/batch loop that fsyncs every
    # iteration serializes the whole batch behind N storage barriers.
    # The sanctioned shape is flush-in-loop + one barrier after -- so
    # functions whose name carries "barrier" (TellWAL.barrier, the
    # scheduler's _barrier_round) are the fix, not the bug, and are
    # exempt wherever the sync call lands inside them.
    in_domain = any(
        p in ("serve", "distributed") for p in ctx.parts[:-1]
    )
    if not in_domain or _is_test_file(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Call)
            and terminal_name(node.func) in _SYNC_CALLS
        ):
            continue
        in_loop = exempt = False
        for anc in ctx.ancestors(node):
            if isinstance(
                anc, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) and "barrier" in anc.name:
                exempt = True
                break
            if isinstance(anc, ast.For) and ctx.enclosing_function(
                node
            ) is ctx.enclosing_function(anc):
                # same function scope: the sync runs once PER ITERATION
                # (a closure merely defined inside the loop does not)
                in_loop = True
                break
        if in_loop and not exempt:
            # keep climbing for a barrier-named enclosing helper
            exempt = any(
                isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
                and "barrier" in a.name
                for a in ctx.ancestors(node)
            )
        if in_loop and not exempt:
            yield ctx.finding(
                "GL308", node,
                f"{terminal_name(node.func)}() inside a for-loop: one "
                "storage barrier per item serializes the batch; flush "
                "in the loop and issue ONE barrier fsync after it "
                "(TellWAL.barrier / the group-commit round shape)",
            )


#: socket calls that block forever unless a deadline is in force: the
#: handle-makers (``makefile`` inherits the socket's timeout -- or its
#: absence) and the raw blocking reads/accepts
_SOCKET_DEADLINE_OPS = frozenset({"makefile", "recv", "recv_into", "accept"})

#: deadline evidence inside one function scope: an explicit
#: ``settimeout``, or the blessed :func:`~..serve.frames.dial` seam
#: (which carries both deadlines by construction)
_SOCKET_DEADLINE_EVIDENCE = frozenset({"settimeout", "dial"})


def _create_connection_has_timeout(call):
    if len(call.args) >= 2:
        return True
    return any(kw.arg == "timeout" for kw in call.keywords)


@register(
    "GL309", "socket-op-without-deadline",
    "create_connection/makefile/recv/accept in serve//distributed//"
    "client.py with no timeout in scope -- a silent peer blocks the "
    "thread forever; dial() (or settimeout before the op) is the "
    "graftstorm contract",
)
def check_socket_op_without_deadline(ctx):
    # the graftstorm rule: every socket op in the serve stack must run
    # under a deadline.  Heuristic, scope-local: a function that calls
    # settimeout, dial(), or create_connection(..., timeout=...) has
    # deadline evidence; a makefile/recv/accept (or a timeout-less
    # create_connection) in a scope WITHOUT evidence is the hung-read
    # shape the storm suite exposes.
    in_domain = any(
        p in ("serve", "distributed") for p in ctx.parts[:-1]
    ) or (ctx.parts and ctx.parts[-1] == "client.py")
    if not in_domain or _is_test_file(ctx):
        return
    for fn in ctx.functions:
        if isinstance(fn, ast.Lambda):
            continue
        own = list(walk_scope(fn))
        calls = [n for n in own if isinstance(n, ast.Call)]
        evidence = any(
            terminal_name(c.func) in _SOCKET_DEADLINE_EVIDENCE
            or (
                terminal_name(c.func) == "create_connection"
                and _create_connection_has_timeout(c)
            )
            for c in calls
        )
        for c in calls:
            name = terminal_name(c.func)
            if (
                name == "create_connection"
                and not _create_connection_has_timeout(c)
            ):
                yield ctx.finding(
                    "GL309", c,
                    "create_connection without a timeout: the connect "
                    "blocks for the OS default (minutes) and the socket "
                    "inherits NO read deadline -- use frames.dial() or "
                    "pass timeout=",
                )
            elif name in _SOCKET_DEADLINE_OPS and not evidence:
                yield ctx.finding(
                    "GL309", c,
                    f"{name}() with no deadline in scope: a silent or "
                    "half-open peer blocks this thread forever -- "
                    "settimeout first (or route through frames.dial)",
                )


_NP_GLOBAL_STATE = frozenset({
    "seed", "rand", "randn", "randint", "random", "uniform", "normal",
    "choice", "shuffle", "permutation", "standard_normal", "beta",
    "binomial", "get_state", "set_state", "sample", "random_sample",
    "exponential", "poisson", "lognormal", "multivariate_normal",
})


#: torch's draws from its process-global generator unless a
#: ``generator=`` is passed; the seeding calls always touch it
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like",
})
_TORCH_GLOBAL_STATE = frozenset({
    "manual_seed", "seed", "initial_seed", "get_rng_state",
    "set_rng_state", "manual_seed_all", "seed_all",
})


def _torch_global_rng(dn, call):
    """``torch.<draw>(...)`` with no ``generator=``, or a seeding call on
    ``torch``/``torch.cuda``."""
    parts = dn.split(".")
    if parts[0] != "torch" or len(parts) > 3:
        return False
    if len(parts) == 3 and parts[1] != "cuda":
        return False
    name = parts[-1]
    if name in _TORCH_GLOBAL_STATE:
        return True
    return (
        len(parts) == 2
        and name in _TORCH_DRAWS
        and not any(kw.arg == "generator" for kw in call.keywords)
    )


@register(
    "GL304", "np-random-global-state",
    "np.random (or torch's default generator) global-state use outside "
    "tests -- seeded streams are the reproducibility contract "
    "(rstate/default_rng/keys only)",
)
def check_np_random_global(ctx):
    if _is_test_file(ctx):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        dn = dotted_name(node.func)
        if dn is None:
            continue
        if _torch_global_rng(dn, node):
            yield ctx.finding(
                "GL304", node,
                f"{dn} reads or reseeds torch's process-global "
                "generator: every draw must come from an explicit key "
                "(random.py) or a torch.Generator passed as generator=",
            )
            continue
        parts = dn.split(".")
        if (
            len(parts) == 3
            and parts[0] in _NUMPY_MODULES
            and parts[1] == "random"
            and parts[2] in _NP_GLOBAL_STATE
        ):
            yield ctx.finding(
                "GL304", node,
                f"{dn} mutates/reads numpy's process-global RNG: every "
                "draw must come from an explicit Generator (default_rng)",
            )
