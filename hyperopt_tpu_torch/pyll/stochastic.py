"""Stochastic pyll ops and the host-side sampling driver (the port's copy).

A copy of :mod:`hyperopt_tpu.pyll.stochastic`: distribution ops
registered into the port's ``scope``, RNG threading via
``recursive_set_rng_kwarg``, and ``sample(expr, rng)``.  These numpy
implementations are the oracle path; the port's suggest path never
interprets these nodes -- :mod:`hyperopt_tpu_torch.ops.compile` lowers
the graph to dense tensor programs.
"""

from __future__ import annotations

import numpy as np

from .base import Apply, as_apply, clone, dfs, rec_eval, scope

__all__ = [
    "STOCHASTIC_NAMES",
    "sample",
    "recursive_set_rng_kwarg",
    "replace_repeat_stochastic",
    "ensure_rng",
]


def ensure_rng(rng):
    """Accept a seed, ``np.random.Generator``, ``RandomState`` or None."""
    if rng is None:
        return np.random.default_rng()
    if isinstance(rng, (int, np.integer)):
        return np.random.default_rng(int(rng))
    return rng


def _size_tuple(size):
    if size == () or size is None:
        return ()
    if isinstance(size, (int, np.integer)):
        return (int(size),)
    return tuple(int(s) for s in size)


# ---------------------------------------------------------------------------
# distribution implementations
# ---------------------------------------------------------------------------


@scope.define
def uniform(low, high, rng=None, size=()):
    rng = ensure_rng(rng)
    return rng.uniform(low, high, size=_size_tuple(size))


@scope.define
def loguniform(low, high, rng=None, size=()):
    rng = ensure_rng(rng)
    return np.exp(rng.uniform(low, high, size=_size_tuple(size)))


@scope.define
def quniform(low, high, q, rng=None, size=()):
    rng = ensure_rng(rng)
    draw = rng.uniform(low, high, size=_size_tuple(size))
    return np.round(draw / q) * q


@scope.define
def qloguniform(low, high, q, rng=None, size=()):
    rng = ensure_rng(rng)
    draw = np.exp(rng.uniform(low, high, size=_size_tuple(size)))
    return np.round(draw / q) * q


@scope.define
def normal(mu, sigma, rng=None, size=()):
    rng = ensure_rng(rng)
    return rng.normal(mu, sigma, size=_size_tuple(size))


@scope.define
def qnormal(mu, sigma, q, rng=None, size=()):
    rng = ensure_rng(rng)
    return np.round(rng.normal(mu, sigma, size=_size_tuple(size)) / q) * q


@scope.define
def lognormal(mu, sigma, rng=None, size=()):
    rng = ensure_rng(rng)
    return np.exp(rng.normal(mu, sigma, size=_size_tuple(size)))


@scope.define
def qlognormal(mu, sigma, q, rng=None, size=()):
    rng = ensure_rng(rng)
    draw = np.exp(rng.normal(mu, sigma, size=_size_tuple(size)))
    return np.round(draw / q) * q


@scope.define
def randint(low, high=None, rng=None, size=()):
    """``randint(upper)`` -> [0, upper); ``randint(low, high)`` -> [low, high)."""
    rng = ensure_rng(rng)
    if high is None:
        low, high = 0, low
    return rng.integers(int(low), int(high), size=_size_tuple(size))


@scope.define
def categorical(p, rng=None, size=()):
    """Draw index ~ Categorical(p)."""
    rng = ensure_rng(rng)
    p = np.asarray(p, dtype=float)
    p = p / p.sum()
    size = _size_tuple(size)
    n = int(np.prod(size)) if size else 1
    draws = rng.choice(len(p), size=n, p=p)
    if not size:
        return draws[0]
    return draws.reshape(size)


@scope.define
def randint_via_categorical(p, rng=None, size=()):
    """Categorical draw standing in for a randint node; used by the TPE
    posterior over integer hyperparameters (SURVEY.md SS2 TPE row (b))."""
    return categorical(p, rng=rng, size=size)


@scope.define
def repeat(n_times, obj):
    return [obj] * int(n_times)


STOCHASTIC_NAMES = (
    "uniform",
    "loguniform",
    "quniform",
    "qloguniform",
    "normal",
    "qnormal",
    "lognormal",
    "qlognormal",
    "randint",
    "categorical",
    "randint_via_categorical",
    # TPE posterior mixture draws are stochastic too (defined in tpe.py):
    "GMM1",
    "LGMM1",
)


def recursive_set_rng_kwarg(expr, rng_node=None):
    """Attach ``rng=rng_node`` to every stochastic node lacking one.

    Mutates the graph in place (matches reference semantics) and returns it.
    """
    if rng_node is None:
        rng_node = as_apply(np.random.default_rng())
    rng_node = as_apply(rng_node)
    for node in dfs(as_apply(expr)):
        if node.name in STOCHASTIC_NAMES:
            if "rng" not in [k for k, _ in node.named_args]:
                node.named_args.append(("rng", rng_node))
                node.named_args.sort()
    return expr


def sample(expr, rng=None, **kwargs):
    """Draw one sample from a stochastic pyll graph."""
    rng = ensure_rng(rng)
    cloned = clone(as_apply(expr))
    recursive_set_rng_kwarg(cloned, as_apply(rng))
    return rec_eval(cloned, **kwargs)


def replace_repeat_stochastic(expr, return_memo=False):
    """Rewrite ``repeat(n, stochastic(...))`` into a single vector draw
    ``stochastic(..., size=n)`` -- the batch-vectorization primitive used by
    the reference's ``vectorize`` (parity: reference
    ``pyll/stochastic.py replace_repeat_stochastic``)."""
    nodes = dfs(as_apply(expr))
    memo = {}
    for node in nodes:
        if node.name != "repeat":
            continue
        n_times, inner = node.pos_args
        if inner.name not in STOCHASTIC_NAMES:
            continue
        named = dict(inner.named_args)
        if "size" in named:
            continue  # already vectorized
        named["size"] = n_times
        vnode = Apply(inner.name, list(inner.pos_args), named, None, pure=False)
        memo[node] = vnode
        # splice into parents
        for parent in nodes:
            parent.replace_input(node, vnode)
    new_expr = memo.get(expr, expr)
    if return_memo:
        return new_expr, memo
    return new_expr
