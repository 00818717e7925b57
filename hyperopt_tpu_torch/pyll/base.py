"""pyll: a tiny lazy symbolic-expression DAG (the port's own copy).

A copy of :mod:`hyperopt_tpu.pyll.base`, kept so that the PyTorch port
imports nothing of the JAX package: ``Apply``/``Literal`` nodes, a
``scope`` symbol table with ``@scope.define``, ``as_apply`` literal
lifting, an iterative ``rec_eval`` with memoization and lazy ``switch``,
and graph utilities (``dfs``, ``toposort``, ``clone``, ``clone_merge``).
The port has its own ``scope``, so a space built with this package's
``hp`` is a different graph from one built with the reference's.
"""

from __future__ import annotations

import copy
import operator

import numpy as np

from ..exceptions import PyllImportError

__all__ = [
    "Apply",
    "Literal",
    "Lambda",
    "SymbolTable",
    "scope",
    "as_apply",
    "rec_eval",
    "dfs",
    "toposort",
    "clone",
    "clone_merge",
    "stochastic_nodes",
]


class Apply:
    """A node in a pyll expression graph: a deferred call ``name(*pos_args,
    **named_args)``.

    Nodes are identity-hashed (graphs are DAGs of *objects*, two
    structurally equal nodes are distinct unless merged via
    :func:`clone_merge`).
    """

    def __init__(self, name, pos_args=(), named_args=(), o_len=None, pure=False):
        self.name = name
        self.pos_args = list(pos_args)
        # named_args kept sorted for deterministic traversal / printing
        self.named_args = sorted((str(k), v) for k, v in dict(named_args).items())
        self.o_len = o_len  # advertised len() of the result, if known
        self.pure = pure  # no side effects / no rng: safe to merge & memo
        for a in self.pos_args:
            assert isinstance(a, Apply), a
        for _, a in self.named_args:
            assert isinstance(a, Apply), a

    # -- graph structure ---------------------------------------------------
    def inputs(self):
        """All child nodes, positional then named (deterministic order)."""
        return self.pos_args + [v for _, v in self.named_args]

    @property
    def arg(self):
        """Named-argument view including positional args bound to the
        implementation's signature where possible (dict label -> node)."""
        binding = {}
        for i, a in enumerate(self.pos_args):
            binding[i] = a
        for k, v in self.named_args:
            binding[k] = v
        return binding

    def clone_from_inputs(self, inputs, o_len="same"):
        if len(inputs) != len(self.pos_args) + len(self.named_args):
            raise ValueError("clone_from_inputs: arity mismatch")
        npos = len(self.pos_args)
        new_pos = list(inputs[:npos])
        new_named = [(k, inputs[npos + i]) for i, (k, _) in enumerate(self.named_args)]
        if o_len == "same":
            o_len = self.o_len
        return self.__class__(self.name, new_pos, new_named, o_len, self.pure)

    def replace_input(self, old_node, new_node):
        """In-place substitution of a direct child; returns positions hit."""
        rval = []
        for i, a in enumerate(self.pos_args):
            if a is old_node:
                self.pos_args[i] = new_node
                rval.append(i)
        for i, (k, a) in enumerate(self.named_args):
            if a is old_node:
                self.named_args[i] = (k, new_node)
                rval.append(k)
        return rval

    # -- syntactic sugar ---------------------------------------------------
    def __getitem__(self, idx):
        if self.o_len is not None and isinstance(idx, int) and idx >= self.o_len:
            raise IndexError(idx)
        return scope.getitem(self, as_apply(idx))

    def __len__(self):
        if self.o_len is None:
            return object.__len__(self)
        return self.o_len

    def __add__(self, other):
        return scope.add(self, as_apply(other))

    def __radd__(self, other):
        return scope.add(as_apply(other), self)

    def __sub__(self, other):
        return scope.sub(self, as_apply(other))

    def __rsub__(self, other):
        return scope.sub(as_apply(other), self)

    def __mul__(self, other):
        return scope.mul(self, as_apply(other))

    def __rmul__(self, other):
        return scope.mul(as_apply(other), self)

    def __truediv__(self, other):
        return scope.truediv(self, as_apply(other))

    def __rtruediv__(self, other):
        return scope.truediv(as_apply(other), self)

    def __floordiv__(self, other):
        return scope.floordiv(self, as_apply(other))

    def __pow__(self, other):
        return scope.pow(self, as_apply(other))

    def __neg__(self):
        return scope.neg(self)

    def __gt__(self, other):
        return scope.gt(self, as_apply(other))

    def __ge__(self, other):
        return scope.ge(self, as_apply(other))

    def __lt__(self, other):
        return scope.lt(self, as_apply(other))

    def __le__(self, other):
        return scope.le(self, as_apply(other))

    def __call__(self, *args, **kwargs):
        return scope.call(self, as_apply(args), as_apply(kwargs))

    # -- printing ----------------------------------------------------------
    def pprint(self, memo=None, depth=0):
        if memo is None:
            memo = {}
        if self in memo:
            return "  " * depth + memo[self]
        memo[self] = f"<node_{len(memo)} {self.name}>"
        lines = ["  " * depth + self.name]
        for a in self.pos_args:
            lines.append(a.pprint(memo, depth + 1))
        for k, v in self.named_args:
            lines.append("  " * (depth + 1) + k + " =")
            lines.append(v.pprint(memo, depth + 2))
        return "\n".join(lines)

    def __repr__(self):
        return f"<pyll.Apply {self.name} @{hex(id(self))}>"

    def __str__(self):
        return self.pprint()


class Literal(Apply):
    """A leaf node wrapping a concrete Python object."""

    def __init__(self, obj=None):
        try:
            o_len = len(obj)
        except TypeError:
            o_len = None
        Apply.__init__(self, "literal", [], {}, o_len, pure=True)
        self._obj = obj

    @property
    def obj(self):
        return self._obj

    def clone_from_inputs(self, inputs, o_len="same"):
        return self.__class__(self._obj)

    def replace_input(self, old_node, new_node):
        return []

    def pprint(self, memo=None, depth=0):
        if memo is None:
            memo = {}
        if self in memo:
            return "  " * depth + memo[self]
        memo[self] = f"<lit_{len(memo)}>"
        return "  " * depth + f"Literal{{{self._obj!r}}}"

    def __repr__(self):
        return f"<pyll.Literal {self._obj!r}>"


class Lambda:
    """A deferred function over pyll graphs.

    ``Lambda('f', [('x', x_node)], expr)`` substitutes call arguments for
    the parameter placeholder nodes and returns a cloned body.  Parity with
    the reference's ``pyll.base.Lambda`` (SURVEY.md SS2, pyll core row).
    """

    def __init__(self, name, params, expr):
        self.__name__ = name
        self.params = list(params)  # list of (name, placeholder Apply)
        self.expr = as_apply(expr)

    def __call__(self, *args, **kwargs):
        memo = {}
        for arg, (pname, pnode) in zip(args, self.params):
            memo[pnode] = as_apply(arg)
        if len(args) < len(self.params):
            for pname, pnode in self.params[len(args):]:
                if pname in kwargs:
                    memo[pnode] = as_apply(kwargs.pop(pname))
        if kwargs:
            raise TypeError(f"unexpected keyword args {sorted(kwargs)}")
        return clone(self.expr, memo)


class UndefinedValue:
    """Sentinel for 'not yet computed' in rec_eval memos."""

    def __repr__(self):
        return "<undefined>"


_undefined = UndefinedValue()


def as_apply(obj):
    """Lift a Python object into a pyll graph.

    dicts -> ``scope.dict`` (sorted keys), lists/tuples -> ``pos_args``,
    Apply passes through, everything else wraps in :class:`Literal`.
    """
    if isinstance(obj, Apply):
        return obj
    if isinstance(obj, tuple):
        return Apply("pos_args", [as_apply(a) for a in obj], {}, len(obj), pure=True)
    if isinstance(obj, list):
        return Apply("pos_args", [as_apply(a) for a in obj], {}, len(obj), pure=True)
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: str(kv[0]))
        named = {str(k): as_apply(v) for k, v in items}
        return Apply("dict", [], named, len(named), pure=True)
    return Literal(obj)


class SymbolTable:
    """Registry of named functions available to pyll graphs.

    ``scope.foo(*args)`` builds an ``Apply('foo', ...)`` node;
    ``@scope.define`` registers the implementation used by ``rec_eval``.
    """

    def __init__(self):
        self._impls = {}
        self._pure = set()

    # define / lookup ------------------------------------------------------
    def define_impl(self, name, f, pure=False, o_len=None):
        if name in self._impls:
            raise ValueError(f"Cannot override symbol {name!r}")
        self._impls[name] = f
        if pure:
            self._pure.add(name)
        return f

    def define(self, f):
        self.define_impl(f.__name__, f, pure=False)
        return f

    def define_pure(self, f):
        self.define_impl(f.__name__, f, pure=True)
        return f

    def define_info(self, o_len=None, pure=False):
        def deco(f):
            self.define_impl(f.__name__, f, pure=pure, o_len=o_len)
            return f

        return deco

    def undefine(self, name):
        self._impls.pop(name, None)
        self._pure.discard(name)

    def impl(self, name):
        try:
            return self._impls[name]
        except KeyError:
            raise PyllImportError(f"Undefined pyll symbol: {name!r}")

    def is_pure(self, name):
        return name in self._pure

    def __contains__(self, name):
        return name in self._impls

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        if name not in self._impls:
            raise AttributeError(f"scope has no symbol {name!r}")

        pure = name in self._pure

        def apply_builder(*args, **kwargs):
            pos = [as_apply(a) for a in args]
            named = {k: as_apply(v) for k, v in kwargs.items()}
            return Apply(name, pos, named, None, pure=pure)

        apply_builder.__name__ = name
        return apply_builder


scope = SymbolTable()


# ---------------------------------------------------------------------------
# graph utilities
# ---------------------------------------------------------------------------


def dfs(expr, seq=None, seen=None):
    """Depth-first post-order traversal (children before parents)."""
    if seq is None:
        assert seen is None
        seq, seen = [], set()
    if id(expr) in seen:
        return seq
    seen.add(id(expr))
    for a in expr.inputs():
        dfs(a, seq, seen)
    seq.append(expr)
    return seq


def toposort(expr):
    """Topological order of the DAG rooted at ``expr`` (inputs first)."""
    return dfs(expr)


def clone(expr, memo=None):
    """Deep-copy a graph; ``memo`` maps old nodes -> replacement nodes."""
    if memo is None:
        memo = {}
    nodes = dfs(expr)
    for node in nodes:
        if node not in memo:
            new_inputs = [memo[a] for a in node.inputs()]
            memo[node] = node.clone_from_inputs(new_inputs)
    return memo[expr]


def _node_key(node, memo):
    """Structural signature used by clone_merge."""
    if isinstance(node, Literal):
        try:
            hash(node.obj)
        except TypeError:
            return ("literal-id", id(node))
        return ("literal", node.obj)
    return (
        node.name,
        tuple(id(memo[a]) for a in node.pos_args),
        tuple((k, id(memo[a])) for k, a in node.named_args),
    )


def clone_merge(expr, memo=None, merge_literals=False):
    """Clone while merging structurally identical *pure* subgraphs."""
    if memo is None:
        memo = {}
    canon = {}
    for node in dfs(expr):
        if node in memo:
            continue
        new_inputs = [memo[a] for a in node.inputs()]
        mergeable = node.pure and (merge_literals or not isinstance(node, Literal))
        if mergeable:
            key = _node_key(node, memo)
            if key in canon:
                memo[node] = canon[key]
                continue
            new_node = node.clone_from_inputs(new_inputs)
            canon[key] = new_node
            memo[node] = new_node
        else:
            memo[node] = node.clone_from_inputs(new_inputs)
    return memo[expr]


def stochastic_nodes(expr, stoch_names):
    """All nodes in ``expr`` whose name is in ``stoch_names``."""
    return [n for n in dfs(expr) if n.name in stoch_names]


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def _eval_apply(node, evaluated):
    """Call a node's implementation on already-evaluated inputs."""
    if isinstance(node, Literal):
        return node.obj
    f = scope.impl(node.name)
    args = [evaluated[id(a)] for a in node.pos_args]
    kwargs = {k: evaluated[id(a)] for k, a in node.named_args}
    return f(*args, **kwargs)


def rec_eval(
    expr, memo=None, max_program_len=100_000, deepcopy_inputs=False, observer=None
):
    """Evaluate a pyll graph.

    Iterative work-stack evaluator (no Python recursion limit) with:

    * ``memo``: dict node -> value overriding evaluation of those nodes
      (this is how Domain substitutes sampled hyperparameter values);
    * lazy ``switch``: only the selected branch is evaluated -- this is what
      makes conditional (``hp.choice``) spaces cheap on host;
    * cycle / runaway-program detection via ``max_program_len``;
    * optional ``observer(node, value)`` hook fired as each Apply node
      resolves -- used by the batch sampler to record which labeled
      hyperparameters were active for a trial.

    Parity: reference ``pyll/base.py rec_eval`` (SURVEY.md SS3.1/SS3.3).
    """
    node = as_apply(expr)
    evaluated = {}  # id(node) -> value
    if memo:
        for k, v in memo.items():
            evaluated[id(k)] = v

    stack = [node]
    steps = 0
    while stack:
        steps += 1
        if steps > max_program_len:
            raise RuntimeError("rec_eval: max program length exceeded")
        current = stack[-1]
        if id(current) in evaluated:
            stack.pop()
            continue

        if isinstance(current, Literal):
            evaluated[id(current)] = current.obj
            stack.pop()
            continue

        if current.name == "switch":
            # lazily evaluate: index first, then only the chosen branch
            idx_node = current.pos_args[0]
            if id(idx_node) not in evaluated:
                stack.append(idx_node)
                continue
            idx = int(evaluated[id(idx_node)])
            options = current.pos_args[1:]
            if not 0 <= idx < len(options):
                raise IndexError(
                    f"switch index {idx} out of range for {len(options)} options"
                )
            chosen = options[idx]
            if id(chosen) not in evaluated:
                stack.append(chosen)
                continue
            evaluated[id(current)] = evaluated[id(chosen)]
            if observer is not None:
                observer(current, evaluated[id(current)])
            stack.pop()
            continue

        waiting = [a for a in current.inputs() if id(a) not in evaluated]
        if waiting:
            stack.extend(waiting)
            continue

        rval = _eval_apply(current, evaluated)
        if deepcopy_inputs:
            rval = copy.deepcopy(rval)
        evaluated[id(current)] = rval
        if observer is not None:
            observer(current, rval)
        stack.pop()

    return evaluated[id(node)]


# ---------------------------------------------------------------------------
# built-in scope symbols
# ---------------------------------------------------------------------------


@scope.define_pure
def pos_args(*args):
    return list(args)


def _dict_impl(**kwargs):
    return kwargs


# registered via define_impl so the module namespace keeps the builtins
scope.define_impl("dict", _dict_impl, pure=True)
scope.define_impl("int", int, pure=True)
scope.define_impl("float", float, pure=True)
scope.define_impl("len", len, pure=True)


@scope.define_pure
def getitem(obj, idx):
    return obj[idx]


@scope.define_pure
def identity(obj):
    return obj


@scope.define
def call(f, args, kwargs):
    return f(*args, **kwargs)


@scope.define_pure
def switch(idx, *options):
    # Only reached when rec_eval's lazy special-case is bypassed
    # (e.g. a user calls the impl directly); semantics identical.
    return options[int(idx)]


@scope.define_pure
def hyperopt_param(label, obj):
    """Marker wrapping a stochastic node with a user-facing label."""
    return obj


# arithmetic ---------------------------------------------------------------

for _name, _f in [
    ("add", operator.add),
    ("sub", operator.sub),
    ("mul", operator.mul),
    ("truediv", operator.truediv),
    ("floordiv", operator.floordiv),
    ("pow", operator.pow),
    ("mod", operator.mod),
    ("gt", operator.gt),
    ("ge", operator.ge),
    ("lt", operator.lt),
    ("le", operator.le),
    ("eq", operator.eq),
    ("neg", operator.neg),
]:
    scope.define_impl(_name, _f, pure=True)

scope.define_impl("div", operator.truediv, pure=True)


@scope.define_pure
def exp(x):
    return np.exp(x)


@scope.define_pure
def log(x):
    return np.log(x)


@scope.define_pure
def sqrt(x):
    return np.sqrt(x)


@scope.define_pure
def floor(x):
    return np.floor(x)


@scope.define_pure
def ceil(x):
    return np.ceil(x)


@scope.define_pure
def maximum(x, y):
    return np.maximum(x, y)


@scope.define_pure
def minimum(x, y):
    return np.minimum(x, y)


scope.define_impl("max", max, pure=True)
scope.define_impl("min", min, pure=True)
scope.define_impl("abs", abs, pure=True)


@scope.define_pure
def array_union(a, b):
    return np.union1d(a, b)


@scope.define_pure
def asarray(a, dtype=None):
    if dtype is None:
        return np.asarray(a)
    return np.asarray(a, dtype=dtype)


@scope.define_pure
def str_join(sep, seq):
    return sep.join(seq)


@scope.define
def partial(name, *args, **kwargs):
    """Return a callable applying scope symbol ``name`` with bound args."""
    f = scope.impl(name)

    def caller(*more, **kwmore):
        kw = {**kwargs, **kwmore}
        return f(*(args + more), **kw)

    caller.__name__ = f"partial({name})"
    return caller
