"""Adaptive TPE on the host, in numpy: ``algo=hyperopt_tpu_torch.atpe_host.suggest``.

The port's copy of :mod:`hyperopt_tpu.atpe`: :class:`ATPEOptimizer` takes
its per-step TPE settings (gamma, candidate count, prior weight, the
stall-triggered restart share) and its lock set from statistics of the
history (the decision layer of :class:`hyperopt_tpu_torch.atpe.
ATPEOptimizer`), and draws each suggestion through the numpy TPE of
:mod:`hyperopt_tpu_torch.tpe_host`.  The card's adaptive TPE is
:mod:`hyperopt_tpu_torch.atpe` (the counterpart of the reference's
``atpe_jax``); this module keeps the reference's name with ``_host``
added, as :mod:`hyperopt_tpu_torch.rand_host` does.
"""

from __future__ import annotations

from . import atpe as _atpe
from . import tpe_host
from .atpe import _ok_trials
from .pyll.stochastic import ensure_rng
from .rand import _domain_helper, docs_from_idxs_vals

__all__ = ["suggest", "ATPEOptimizer"]


class ATPEOptimizer(_atpe.ATPEOptimizer):
    """The adaptive decisions with the host TPE behind them.

    ``tpe_settings`` also names the card's categorical candidate default
    (``n_EI_candidates_cat``); the host draws read the other fields and
    apply their one ``n_EI_candidates`` to every dim, anchored at 24.
    """

    def suggest_config(self, domain, trials, rng, n_startup_jobs=20):
        """One config: a prior draw during startup and on a restart,
        else the host TPE's posterior draws with the converged labels
        locked before routing (so a locked choice re-routes its subtree)."""
        helper = _domain_helper(domain)
        ok = _ok_trials(trials)
        if len(ok) < n_startup_jobs:
            return helper.sample_one(rng)

        settings = self.tpe_settings(domain, trials)
        if rng.uniform() < settings.get("explore_fraction", 0.0):
            # a stall-triggered restart skips locking too: a restart that
            # keeps the converged values is not a restart
            return helper.sample_one(rng)
        locked = self.locked_values(domain, trials, rng)

        draws = tpe_host._posterior_draws(
            domain, trials, rng,
            prior_weight=settings["prior_weight"],
            n_EI_candidates=settings["n_EI_candidates"],
            gamma=settings["gamma"],
            LF=tpe_host._default_linear_forgetting,
        )
        draws.update(locked)
        return tpe_host._route_draws(domain, draws)


def suggest(new_ids, domain, trials, seed, n_startup_jobs=20,
            lock_fraction=0.5, elite_count=8):
    """The plugin-boundary entry point: ``algo=hyperopt_tpu_torch.atpe_host.suggest``."""
    rng = ensure_rng(seed)
    opt = getattr(domain, "_atpe_optimizer", None)
    if (opt is None or opt.lock_fraction != lock_fraction
            or opt.elite_count != elite_count):
        opt = ATPEOptimizer(lock_fraction=lock_fraction, elite_count=elite_count)
        domain._atpe_optimizer = opt
    helper = _domain_helper(domain)
    labels = sorted(helper.hps)
    idxs = {label: [] for label in labels}
    vals = {label: [] for label in labels}
    for tid in new_ids:
        config = opt.suggest_config(
            domain, trials, rng, n_startup_jobs=n_startup_jobs
        )
        for label, value in config.items():
            idxs[label].append(tid)
            vals[label].append(value)
    return docs_from_idxs_vals(new_ids, domain, trials, idxs, vals)
