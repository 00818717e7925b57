"""Random search on the card: ``algo=hyperopt_tpu_torch.rand.suggest``.

The counterpart of :mod:`hyperopt_tpu.rand_jax`: one prior draw of the
compiled space makes the whole batch (dense values + active masks) on
the domain's device.  ``suggest(speculative=k)`` serves ``k`` sequential
asks from one k-wide draw; prior draws never go stale, so the cached
columns are exact.  Also the port's copies of
:func:`hyperopt_tpu.rand.docs_from_idxs_vals` and ``_domain_helper``.
"""

from __future__ import annotations

from . import random as R
from .torch_trials import packed_space_for
from .vectorize import VectorizeHelper, dense_to_idxs_vals

__all__ = ["docs_from_idxs_vals", "suggest", "suggest_batch"]


def _domain_helper(domain):
    """The domain's host sampler (:class:`VectorizeHelper`), built once."""
    helper = getattr(domain, "_vectorize_helper", None)
    if helper is None:
        helper = VectorizeHelper(domain.expr)
        domain._vectorize_helper = helper
    return helper


def docs_from_idxs_vals(new_ids, domain, trials, idxs, vals):
    """Build NEW trial documents from a sparse batch encoding."""
    labels = sorted(idxs)
    rval_specs = []
    rval_results = []
    rval_miscs = []
    for tid in new_ids:
        misc = {
            "tid": tid,
            "cmd": domain.cmd,
            "workdir": domain.workdir,
            "idxs": {label: [] for label in labels},
            "vals": {label: [] for label in labels},
        }
        rval_specs.append(None)
        rval_results.append(domain.new_result())
        rval_miscs.append(misc)
    by_tid = {m["tid"]: m for m in rval_miscs}
    for label in labels:
        for tid, val in zip(idxs[label], vals[label]):
            by_tid[tid]["idxs"][label] = [tid]
            by_tid[tid]["vals"][label] = [val]
    return trials.new_trial_docs(new_ids, rval_specs, rval_results, rval_miscs)


def _dense_draw(domain, seed, batch):
    """One prior draw of ``batch`` trials on the domain's device, as host
    numpy; counted on the domain (``_rand_draws``)."""
    ps = packed_space_for(domain)
    domain._rand_draws = getattr(domain, "_rand_draws", 0) + 1
    values, active = ps.sample_prior(R.key(int(seed) % (2**31 - 1), device=ps.device), batch)
    return values.cpu().numpy(), active.cpu().numpy()


def suggest_batch(new_ids, domain, trials, seed):
    """Sparse (idxs, vals) for a batch of new trial ids: one prior draw."""
    from .tpe import _cast_vals  # tpe imports this module

    ps = packed_space_for(domain)
    values, active = _dense_draw(domain, seed, len(new_ids))
    return _cast_vals(ps, *dense_to_idxs_vals(new_ids, ps.labels, values, active))


def suggest(new_ids, domain, trials, seed, speculative=0):
    """The plugin-boundary entry point: ``algo=hyperopt_tpu_torch.rand.suggest``."""
    if speculative and len(new_ids) == 1:
        from .tpe import _cast_vals, _speculative_cols

        ps = packed_space_for(domain)
        values, active = _speculative_cols(
            domain, trials, seed, int(speculative),
            2**62,  # prior draws never go stale
            ("rand", int(speculative), id(trials)),
            0,  # no startup regime: always 'warm'
            lambda s, k: _dense_draw(domain, s, k),
        )
        idxs, vals = _cast_vals(ps, *dense_to_idxs_vals(new_ids, ps.labels, values, active))
    else:
        idxs, vals = suggest_batch(new_ids, domain, trials, seed)
    return docs_from_idxs_vals(new_ids, domain, trials, idxs, vals)
