"""The checkpoint guard's identity helpers (a copy of two functions of
:mod:`hyperopt_tpu.hyperband`).

The compiled loop's chunk bundles record the experiment they belong to,
and a resume under another algorithm or space is refused.  The
multi-fidelity schedulers of the reference's module are not ported yet
(``ROADMAP.md`` Queue A, item 14).
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from .pyll.base import Literal, dfs

__all__ = ["_algo_identity", "_space_fingerprint"]


def _algo_identity(algo):
    """Checkpoint-guard identity of an algo or objective: its module and
    qualified name (``functools.partial`` unwraps to its base function;
    tuned kwargs are not fingerprinted)."""
    a = algo
    while isinstance(a, functools.partial):
        a = a.func
    return (
        f"{getattr(a, '__module__', '?')}."
        f"{getattr(a, '__qualname__', type(a).__name__)}"
    )


def _space_fingerprint(expr):
    """Stable structural hash of a pyll space graph: distributions, bounds,
    labels and the order of choice options change it; process identity
    does not.  Literal values that are not plain data hash by their type
    name (their place in the graph still counts)."""

    def norm(v):
        if isinstance(v, (str, int, float, bool, type(None))):
            return repr(v)
        if isinstance(v, np.generic):
            return f"np.{type(v).__name__}({v!r})"
        if isinstance(v, np.ndarray):
            if v.dtype == object:
                return f"nd.object{norm(v.tolist())}"
            digest = hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            return f"nd({v.dtype},{v.shape},{digest})"
        if isinstance(v, (list, tuple)):
            return f"{type(v).__name__}({','.join(norm(x) for x in v)})"
        if isinstance(v, dict):
            items = ",".join(f"{norm(k)}:{norm(v[k])}" for k in sorted(v, key=repr))
            return f"dict({items})"
        return f"<{type(v).__module__}.{type(v).__qualname__}>"

    parts = []
    for node in dfs(expr):
        if isinstance(node, Literal):
            parts.append(f"L:{norm(node.obj)}")
        else:
            kw = ",".join(sorted(k for k, _ in node.named_args))
            parts.append(f"A:{node.name}/{len(node.pos_args)}/{kw}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()
