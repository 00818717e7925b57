"""pyll: symbolic expression graphs for search spaces (host-side layer L0)."""

from . import base, stochastic
from .base import (
    Apply,
    Lambda,
    Literal,
    SymbolTable,
    as_apply,
    clone,
    clone_merge,
    dfs,
    rec_eval,
    scope,
    stochastic_nodes,
    toposort,
)
from .stochastic import sample, recursive_set_rng_kwarg, STOCHASTIC_NAMES

__all__ = [
    "Apply",
    "Lambda",
    "Literal",
    "SymbolTable",
    "as_apply",
    "base",
    "clone",
    "clone_merge",
    "dfs",
    "rec_eval",
    "recursive_set_rng_kwarg",
    "sample",
    "scope",
    "stochastic",
    "stochastic_nodes",
    "toposort",
    "STOCHASTIC_NAMES",
]
