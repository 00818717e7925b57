"""NAS-Bench-201-style architecture search benchmark (choice-heavy space);
the port's copy of :mod:`hyperopt_tpu.models.nasbench`, built with its ``hp``.

BASELINE.json config #5: the NAS-Bench-201 cell is a DAG on 4 nodes with
6 edges, each edge labeled by one of 5 operations -- as a search space,
6 stacked ``hp.choice`` dims (5^6 = 15625 architectures).  The real
benchmark is a lookup table of trained accuracies; this hermetic stand-in
synthesizes a table with the same statistical character: strong per-edge
op marginals, pairwise edge interactions, and a deterministic per-arch
residual.  ``tabular=True`` precomputes the full 15625-entry table (so
the judge can verify against exhaustive argmin); the default computes
entries on demand.
"""

from __future__ import annotations

import itertools

import numpy as np

from .. import hp

__all__ = [
    "OPS",
    "N_EDGES",
    "space",
    "objective",
    "arch_from_config",
    "full_table",
    "optimal_loss",
]

OPS = ("none", "skip_connect", "nor_conv_1x1", "nor_conv_3x3", "avg_pool_3x3")
N_EDGES = 6  # 4-node cell: edges (0,1),(0,2),(0,3),(1,2),(1,3),(2,3)

# deterministic structured table parameters (fixed seed; part of the
# benchmark definition, like a checked-in lookup table)
_rng = np.random.default_rng(201)
# marginal utility of op o on edge e
_MARGINAL = _rng.normal(0.0, 1.0, size=(N_EDGES, len(OPS)))
# conv ops are better on average; 'none' prunes capacity
_MARGINAL[:, OPS.index("nor_conv_3x3")] += 1.2
_MARGINAL[:, OPS.index("nor_conv_1x1")] += 0.8
_MARGINAL[:, OPS.index("none")] -= 1.0
# pairwise interactions between edge ops
_PAIRS = _rng.normal(0.0, 0.25, size=(N_EDGES, N_EDGES, len(OPS), len(OPS)))


def space():
    """6 x hp.choice over the 5 ops (flat choice-heavy space)."""
    return {f"edge{e}": hp.choice(f"edge{e}", list(range(len(OPS))))
            for e in range(N_EDGES)}


def arch_from_config(cfg):
    return tuple(int(cfg[f"edge{e}"]) for e in range(N_EDGES))


def _raw_score(arch):
    s = sum(_MARGINAL[e, op] for e, op in enumerate(arch))
    for e1 in range(N_EDGES):
        for e2 in range(e1 + 1, N_EDGES):
            s += _PAIRS[e1, e2, arch[e1], arch[e2]]
    # deterministic residual (per-arch 'training noise'); Python ints with
    # an explicit 64-bit mask give the same wraparound as uint64 without
    # numpy's overflow RuntimeWarning
    h = 0
    for op in arch:
        h = (h * 1000003 + op + 1) & 0xFFFFFFFFFFFFFFFF
    resid = (float(h % 10_000) / 10_000.0 - 0.5) * 0.3
    return s + resid


def objective(cfg):
    """Loss = 100 - synthetic accuracy (%), in roughly [5, 45]."""
    arch = arch_from_config(cfg)
    score = _raw_score(arch)
    acc = 55.0 + 40.0 / (1.0 + np.exp(-0.35 * score))  # 55..95%
    return float(100.0 - acc)


_table_cache = None


def full_table():
    """All 15625 (arch, loss) pairs (cached)."""
    global _table_cache
    if _table_cache is None:
        archs = list(itertools.product(range(len(OPS)), repeat=N_EDGES))
        losses = np.array(
            [objective({f"edge{e}": a[e] for e in range(N_EDGES)}) for a in archs]
        )
        _table_cache = (archs, losses)
    return _table_cache


def optimal_loss():
    _, losses = full_table()
    return float(losses.min())
