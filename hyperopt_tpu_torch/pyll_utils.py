"""Graph analysis helpers over hp-annotated pyll spaces (the port's copy).

A copy of :mod:`hyperopt_tpu.pyll_utils`: label validation,
``expr_to_config`` (label -> distribution + activation conditions) and
``DuplicateLabel`` detection.  ``expr_to_config`` drives the port's space
compiler (:mod:`hyperopt_tpu_torch.ops.compile`).
"""

from __future__ import annotations

from collections import namedtuple

from .exceptions import DuplicateLabel, InvalidAnnotatedParameter
from .pyll.base import Apply, Literal, as_apply

__all__ = ["EQ", "validate_label", "expr_to_config", "ParamInfo", "expr_signature"]


class EQ(namedtuple("EQ", ["name", "val"])):
    """Activation condition: hyperparameter ``name`` drew value ``val``."""

    __slots__ = ()

    def __repr__(self):
        return f"EQ({self.name!r}=={self.val!r})"


def validate_label(label):
    if not isinstance(label, str):
        raise InvalidAnnotatedParameter(
            f"hp label must be a string, got {type(label).__name__}: {label!r}"
        )
    if label == "":
        raise InvalidAnnotatedParameter("hp label must be non-empty")
    return label


def expr_signature(node):
    """Structural signature of a graph (for duplicate-label detection)."""
    if isinstance(node, Literal):
        try:
            hash(node.obj)
            return ("lit", node.obj)
        except TypeError:
            return ("lit-id", id(node))
    return (
        node.name,
        tuple(expr_signature(a) for a in node.pos_args),
        tuple((k, expr_signature(a)) for k, a in node.named_args),
    )


def _const_value(node):
    """Constant-fold a pure subgraph (e.g. a lifted list of floats) to its
    value; symbolic (impure/param-dependent) args stay as Apply nodes."""
    from .pyll.base import dfs, rec_eval, scope

    if isinstance(node, Literal):
        return node.obj
    for n in dfs(node):
        if not (isinstance(n, Literal) or scope.is_pure(n.name)):
            return node
    return rec_eval(node)


class ParamInfo:
    """Everything known about one labeled hyperparameter.

    Attributes:
      label: user-facing name.
      node: the distribution Apply node (e.g. ``uniform(low, high)``).
      conditions: set of condition-tuples; the param is *active* when ANY
        tuple is fully satisfied (each tuple is a conjunction of EQ terms).
        An empty tuple in the set means unconditionally active.
      dist: distribution name (``uniform``, ``randint``, ``categorical``...).
      params: dict of evaluated distribution arguments (floats / arrays),
        when they are literal; symbolic args keep the Apply node.
    """

    def __init__(self, label, node):
        self.label = label
        self.node = node
        self.conditions = set()
        self.dist = node.name
        self.params = {}
        self._extract_params()

    def _extract_params(self):
        names_by_dist = {
            "uniform": ("low", "high"),
            "loguniform": ("low", "high"),
            "quniform": ("low", "high", "q"),
            "qloguniform": ("low", "high", "q"),
            "normal": ("mu", "sigma"),
            "qnormal": ("mu", "sigma", "q"),
            "lognormal": ("mu", "sigma"),
            "qlognormal": ("mu", "sigma", "q"),
            "randint": ("low", "high"),
            "categorical": ("p",),
            "randint_via_categorical": ("p",),
        }
        arg_names = names_by_dist.get(self.dist)
        if arg_names is None:
            raise InvalidAnnotatedParameter(
                f"hp node {self.label!r} wraps unsupported distribution "
                f"{self.dist!r}"
            )
        for i, a in enumerate(self.node.pos_args):
            if i < len(arg_names):
                self.params[arg_names[i]] = _const_value(a)
        for k, a in self.node.named_args:
            if k in ("rng", "size"):
                continue
            self.params[k] = _const_value(a)
        # normalize randint(upper) -> low=0, high=upper
        if self.dist == "randint" and "high" not in self.params:
            self.params["high"] = self.params.pop("low")
            self.params["low"] = 0

    @property
    def unconditional(self):
        return () in self.conditions or not self.conditions

    def __repr__(self):
        return (
            f"ParamInfo({self.label!r}, {self.dist}, {self.params}, "
            f"conditions={sorted(map(repr, self.conditions))})"
        )


def _hp_label_and_dist(hparam_node):
    label_node = hparam_node.pos_args[0]
    if not isinstance(label_node, Literal):
        raise InvalidAnnotatedParameter("hyperopt_param label must be a literal")
    return label_node.obj, hparam_node.pos_args[1]


def expr_to_config(expr, conditions=(), hps=None):
    """Extract {label: ParamInfo} from an hp-annotated space graph.

    Walks the graph tracking ``switch`` branches so each hyperparameter
    records the conjunction of choice outcomes under which it is active.
    Raises :class:`DuplicateLabel` if a label appears twice with different
    distributions (same-structure re-use merges conditions, matching
    reference behavior).
    """
    expr = as_apply(expr)
    if hps is None:
        hps = {}
    _walk(expr, tuple(conditions), hps, set())
    return hps


def _record(hps, label, dist_node, conditions):
    if label in hps:
        prev = hps[label]
        if expr_signature(prev.node) != expr_signature(dist_node):
            raise DuplicateLabel(
                f"label {label!r} used for two different distributions"
            )
        prev.conditions.add(conditions)
    else:
        info = ParamInfo(label, dist_node)
        info.conditions.add(conditions)
        hps[label] = info


def _walk(node, conditions, hps, seen):
    # NOTE: (node, conditions) pairs must be revisited when the same subtree
    # is reachable under different conditions -> key includes conditions.
    key = (id(node), conditions)
    if key in seen:
        return
    seen.add(key)

    if isinstance(node, Literal):
        return

    if node.name == "switch":
        idx_node = node.pos_args[0]
        if idx_node.name == "hyperopt_param":
            label, dist_node = _hp_label_and_dist(idx_node)
            validate_label(label)
            _record(hps, label, dist_node, conditions)
            _walk(dist_node, conditions, hps, seen)
            for i, option in enumerate(node.pos_args[1:]):
                _walk(option, conditions + (EQ(label, i),), hps, seen)
            return
        # unlabeled switch: all branches share current conditions
        for a in node.inputs():
            _walk(a, conditions, hps, seen)
        return

    if node.name == "hyperopt_param":
        label, dist_node = _hp_label_and_dist(node)
        validate_label(label)
        _record(hps, label, dist_node, conditions)
        _walk(dist_node, conditions, hps, seen)
        return

    for a in node.inputs():
        _walk(a, conditions, hps, seen)
