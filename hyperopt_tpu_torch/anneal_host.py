"""Annealing on the host, in numpy: ``algo=hyperopt_tpu_torch.anneal_host.suggest``.

The port's copy of :mod:`hyperopt_tpu.anneal`: each new config is drawn
near a good past trial (its rank geometric around ``avg_best_idx``), in a
neighbourhood whose share of the prior range shrinks as
``1 / (1 + n_obs * shrink_coef)``.  The card's annealing is
:mod:`hyperopt_tpu_torch.anneal` (the counterpart of the reference's
``anneal_jax``); this module keeps the reference's name with ``_host``
added, as :mod:`hyperopt_tpu_torch.rand_host` does.
"""

from __future__ import annotations

import numpy as np

from .base import JOB_STATE_DONE, STATUS_OK, miscs_to_idxs_vals
from .pyll.base import rec_eval
from .pyll.stochastic import ensure_rng
from .rand import docs_from_idxs_vals
from .vectorize import VectorizeHelper

__all__ = ["suggest", "AnnealingAlgo"]


def _qround(x, q):
    return np.round(x / q) * q


class AnnealingAlgo:
    """One annealing step over a Domain's search space.

    avg_best_idx: mean rank of the anchor trial drawn from the sorted-by-
      loss history (2.0 -> usually one of the few best).
    shrink_coef: neighborhood shrink rate; fraction of the prior range used
      at n observations is ``1 / (1 + n * shrink_coef)``.
    """

    def __init__(self, domain, trials, seed, avg_best_idx=2.0, shrink_coef=0.1):
        self.domain = domain
        self.trials = trials
        self.rng = ensure_rng(seed)
        self.avg_best_idx = avg_best_idx
        self.shrink_coef = shrink_coef
        helper = getattr(domain, "_vectorize_helper", None)
        if helper is None:
            helper = VectorizeHelper(domain.expr)
            domain._vectorize_helper = helper
        self.helper = helper
        self.hps = helper.hps

    # -- history -----------------------------------------------------------
    def _ok_trials(self):
        return [
            t
            for t in self.trials.trials
            if t["state"] == JOB_STATE_DONE
            and t["result"].get("status") == STATUS_OK
            and t["result"].get("loss") is not None
        ]

    def _anchor_config(self, ok_trials):
        """Pick a good past trial (geometric over loss rank) -> its config."""
        losses = np.array([float(t["result"]["loss"]) for t in ok_trials])
        order = np.argsort(losses)
        rank = int(self.rng.geometric(1.0 / self.avg_best_idx) - 1)
        rank = min(rank, len(order) - 1)
        anchor = ok_trials[order[rank]]
        return {
            k: v[0]
            for k, v in anchor["misc"]["vals"].items()
            if len(v) == 1
        }

    def _n_obs(self, label, ok_trials):
        return sum(1 for t in ok_trials if len(t["misc"]["vals"].get(label, [])) == 1)

    def shrink_frac(self, n_obs):
        return 1.0 / (1.0 + n_obs * self.shrink_coef)

    # -- per-distribution draws -------------------------------------------
    def prior_draw(self, info):
        rng = self.rng
        p = info.params
        d = info.dist
        if d == "uniform":
            return rng.uniform(p["low"], p["high"])
        if d == "quniform":
            return _qround(rng.uniform(p["low"], p["high"]), p["q"])
        if d == "loguniform":
            return np.exp(rng.uniform(p["low"], p["high"]))
        if d == "qloguniform":
            return _qround(np.exp(rng.uniform(p["low"], p["high"])), p["q"])
        if d == "normal":
            return rng.normal(p["mu"], p["sigma"])
        if d == "qnormal":
            return _qround(rng.normal(p["mu"], p["sigma"]), p["q"])
        if d == "lognormal":
            return np.exp(rng.normal(p["mu"], p["sigma"]))
        if d == "qlognormal":
            return _qround(np.exp(rng.normal(p["mu"], p["sigma"])), p["q"])
        if d == "randint":
            return int(rng.integers(p["low"], p["high"]))
        if d in ("categorical", "randint_via_categorical"):
            probs = np.asarray(p["p"], dtype=float)
            return int(rng.choice(len(probs), p=probs / probs.sum()))
        raise NotImplementedError(d)

    def neighborhood_draw(self, info, anchor_val, n_obs):
        """Draw near ``anchor_val`` with a neighborhood shrunk by history."""
        rng = self.rng
        p = info.params
        d = info.dist
        frac = self.shrink_frac(n_obs)

        def trunc_uniform(center, low, high):
            width = (high - low) * frac
            lo = max(low, center - width / 2)
            hi = min(high, center + width / 2)
            if hi <= lo:
                return center
            return rng.uniform(lo, hi)

        if d == "uniform":
            return trunc_uniform(anchor_val, p["low"], p["high"])
        if d == "quniform":
            return _qround(trunc_uniform(anchor_val, p["low"], p["high"]), p["q"])
        if d == "loguniform":
            return np.exp(trunc_uniform(np.log(anchor_val), p["low"], p["high"]))
        if d == "qloguniform":
            v = max(anchor_val, np.exp(p["low"]))
            return _qround(
                np.exp(trunc_uniform(np.log(v), p["low"], p["high"])), p["q"]
            )
        if d == "normal":
            return rng.normal(anchor_val, p["sigma"] * frac)
        if d == "qnormal":
            return _qround(rng.normal(anchor_val, p["sigma"] * frac), p["q"])
        if d == "lognormal":
            return np.exp(rng.normal(np.log(max(anchor_val, 1e-12)), p["sigma"] * frac))
        if d == "qlognormal":
            return _qround(
                np.exp(rng.normal(np.log(max(anchor_val, 1e-12)), p["sigma"] * frac)),
                p["q"],
            )
        if d == "randint":
            if rng.uniform() < frac:
                return int(rng.integers(p["low"], p["high"]))
            return int(anchor_val)
        if d in ("categorical", "randint_via_categorical"):
            if rng.uniform() < frac:
                probs = np.asarray(p["p"], dtype=float)
                return int(rng.choice(len(probs), p=probs / probs.sum()))
            return int(anchor_val)
        raise NotImplementedError(d)

    # -- one batch ---------------------------------------------------------
    def sample_batch(self, new_ids):
        ok_trials = self._ok_trials()
        idxs = {label: [] for label in self.hps}
        vals = {label: [] for label in self.hps}
        n_obs = {label: self._n_obs(label, ok_trials) for label in self.hps}

        for tid in new_ids:
            if ok_trials:
                anchor = self._anchor_config(ok_trials)
            else:
                anchor = {}
            draws = {}
            for label, info in self.hps.items():
                if label in anchor:
                    draws[label] = self.neighborhood_draw(
                        info, anchor[label], n_obs[label]
                    )
                else:
                    draws[label] = self.prior_draw(info)
            # route through the space graph: only active labels recorded
            memo = {info.node: draws[label] for label, info in self.hps.items()}
            active = {}

            def observer(node, value):
                if node.name == "hyperopt_param":
                    active[node.pos_args[0].obj] = value

            rec_eval(self.domain.expr, memo=memo, observer=observer)
            for label, value in active.items():
                idxs[label].append(tid)
                vals[label].append(value)
        return idxs, vals

    def __call__(self, new_ids):
        idxs, vals = self.sample_batch(new_ids)
        return docs_from_idxs_vals(new_ids, self.domain, self.trials, idxs, vals)


def suggest(new_ids, domain, trials, seed, avg_best_idx=2.0, shrink_coef=0.1):
    """The plugin-boundary entry point: ``algo=hyperopt_tpu_torch.anneal_host.suggest``."""
    algo = AnnealingAlgo(
        domain, trials, seed, avg_best_idx=avg_best_idx, shrink_coef=shrink_coef
    )
    return algo(new_ids)
