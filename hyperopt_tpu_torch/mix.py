"""Probabilistic mixture over suggest algorithms (the port's copy of
:mod:`hyperopt_tpu.mix`): each call hands the new ids to one algorithm,
drawn with its probability, under a seed drawn from the same rng."""

from __future__ import annotations

import numpy as np

from .pyll.stochastic import ensure_rng

__all__ = ["suggest"]


def suggest(new_ids, domain, trials, seed, p_suggest):
    """Call one of several suggest functions, chosen with probability p.

    ``p_suggest``: list of (probability, suggest_fn) pairs.  Use with e.g.
    ``partial(mix.suggest, p_suggest=[(0.8, tpe.suggest), (0.2, rand_host.suggest)])``.
    """
    rng = ensure_rng(seed)
    ps, suggests = zip(*p_suggest)
    ps = np.asarray(ps, dtype=float)
    if abs(ps.sum() - 1.0) > 1e-5:
        raise ValueError(f"p_suggest probabilities must sum to 1.0, got {ps.sum()}")
    idx = int(rng.choice(len(ps), p=ps / ps.sum()))
    return suggests[idx](
        new_ids, domain, trials, seed=int(rng.integers(2**31 - 1))
    )
