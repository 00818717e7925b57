"""Random search on the host: ``algo=hyperopt_tpu_torch.rand_host.suggest``.

The port's copy of the reference's numpy random search
(:mod:`hyperopt_tpu.rand`): each new trial's config is one evaluation of
the space's pyll graph under a seeded numpy generator, so the same seed
suggests the same trial docs bit for bit.  It is the default rung-0
algorithm of the host schedulers (:mod:`hyperopt_tpu_torch.hyperband`),
as the reference's drivers default to its ``rand.suggest``.  The card's
random search, :mod:`hyperopt_tpu_torch.rand`, is the counterpart of the
reference's ``rand_jax``.
"""

from __future__ import annotations

from .pyll.stochastic import ensure_rng
from .rand import _domain_helper, docs_from_idxs_vals

__all__ = ["suggest", "suggest_batch"]


def suggest_batch(new_ids, domain, trials, seed):
    """Sparse (idxs, vals) for a batch of new trial ids."""
    return _domain_helper(domain).sample_batch(new_ids, ensure_rng(seed))


def suggest(new_ids, domain, trials, seed):
    """The plugin-boundary entry point."""
    idxs, vals = suggest_batch(new_ids, domain, trials, seed)
    return docs_from_idxs_vals(new_ids, domain, trials, idxs, vals)


# random search explores the whole prior: fmin's duplicate-coverage
# warning does not apply
suggest.is_exhaustive = False
