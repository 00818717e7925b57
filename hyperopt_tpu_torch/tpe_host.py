"""The Tree-structured Parzen Estimator on the host, in numpy:
``algo=hyperopt_tpu_torch.tpe_host.suggest``.

The port's copy of :mod:`hyperopt_tpu.tpe`, the reference's numpy TPE:
adaptive-Parzen 1-D GMM fits (neighbour-difference sigmas, sigma
clipping, a prior component, linear forgetting), truncated and quantized
GMM sampling and log-densities (``GMM1``/``LGMM1``), categorical
posteriors from weighted counts, the good/bad split at
``n_below = min(ceil(gamma * sqrt(n)), LF)`` and a factorized EI argmax
per hyperparameter over ``n_EI_candidates`` draws.  Sampling is by
inverse-CDF truncation, never rejection.

The card's TPE is :mod:`hyperopt_tpu_torch.tpe` (the counterpart of the
reference's ``tpe_jax``); this module is the host baseline it is measured
against, so it keeps the reference's name with ``_host`` added, as
:mod:`hyperopt_tpu_torch.rand_host` does.  The hot fits and
log-densities go through the C++ host library
(:mod:`hyperopt_tpu_torch.native`) when ``_native()`` returns it; patch
``_native`` to return None to pin the numpy oracle.
"""

from __future__ import annotations

import logging

import numpy as np
from scipy.special import ndtri  # inverse normal CDF

from .base import JOB_STATE_DONE, STATUS_OK, posterior_state
from .pyll.base import rec_eval, scope
from .pyll.stochastic import ensure_rng
from .rand import _domain_helper, docs_from_idxs_vals

logger = logging.getLogger(__name__)


def _native():
    """The optional C++ host-math library (None when unavailable)."""
    from . import native as _native_mod

    return _native_mod if _native_mod.available() else None


__all__ = [
    "suggest",
    "suggest_batch",
    "adaptive_parzen_normal",
    "adaptive_parzen_normal_orig",
    "linear_forgetting_weights",
    "normal_cdf",
    "GMM1",
    "GMM1_lpdf",
    "LGMM1",
    "LGMM1_lpdf",
    "ap_split_trials",
    "ap_filter_trials",
    "broadcast_best",
    "adaptive_parzen_samplers",
]

# -- defaults (the reference's module constants) ---------------------------
_default_prior_weight = 1.0
_default_n_EI_candidates = 24
_default_gamma = 0.25
_default_n_startup_jobs = 20
_default_linear_forgetting = 25

EPS = 1e-12


# ---------------------------------------------------------------------------
# weights / parzen fitting
# ---------------------------------------------------------------------------


def linear_forgetting_weights(N, LF):
    """Weights over N time-ordered observations: newest LF get weight 1,
    older ones ramp linearly down toward 1/N (oldest first in the array)."""
    if N == 0:
        return np.asarray([], dtype=float)
    if N < LF:
        return np.ones(N)
    ramp = np.linspace(1.0 / N, 1.0, num=N - LF)
    flat = np.ones(LF)
    return np.concatenate([ramp, flat])


def adaptive_parzen_normal(mus, prior_weight, prior_mu, prior_sigma, LF=None):
    """Fit a 1-D GMM over observed values ``mus`` (time order).

    Components: one per observation plus a prior component at
    ``(prior_mu, prior_sigma)`` inserted in sorted position.  Sigmas are
    neighbor differences (max of left/right gap), clipped to
    ``[prior_sigma / min(100, 1 + n), prior_sigma]``.  Weights carry linear
    forgetting beyond ``LF`` observations; the prior gets ``prior_weight``.

    Returns (weights, mus, sigmas) sorted by mu, weights normalized.
    """
    if LF is None:
        LF = _default_linear_forgetting
    nat = _native()
    if nat is not None:
        fit = nat.adaptive_parzen(mus, prior_weight, prior_mu, prior_sigma, LF)
        if fit is not None:
            return fit
    return adaptive_parzen_normal_numpy(mus, prior_weight, prior_mu,
                                        prior_sigma, LF)


def adaptive_parzen_normal_numpy(mus, prior_weight, prior_mu, prior_sigma,
                                 LF=None):
    """Pure-numpy adaptive-Parzen fit (the oracle the native/JAX paths are
    validated against)."""
    if LF is None:
        LF = _default_linear_forgetting
    mus = np.asarray(mus, dtype=float)
    n = len(mus)

    if n == 0:
        srtd_mus = np.asarray([prior_mu], dtype=float)
        sigma = np.asarray([prior_sigma], dtype=float)
        prior_pos = 0
        srtd_weights = np.asarray([1.0])
    else:
        order = np.argsort(mus)
        prior_pos = int(np.searchsorted(mus[order], prior_mu))
        srtd_mus = np.insert(mus[order], prior_pos, prior_mu)
        m = len(srtd_mus)
        sigma = np.zeros(m)
        if m == 1:
            sigma[:] = prior_sigma
        elif m == 2:
            gap = abs(srtd_mus[1] - srtd_mus[0])
            sigma[:] = np.maximum(gap, EPS)
        else:
            left_gap = srtd_mus[1:-1] - srtd_mus[:-2]
            right_gap = srtd_mus[2:] - srtd_mus[1:-1]
            sigma[1:-1] = np.maximum(left_gap, right_gap)
            sigma[0] = srtd_mus[1] - srtd_mus[0]
            sigma[-1] = srtd_mus[-1] - srtd_mus[-2]
        # clip, then pin the prior component's sigma
        maxsigma = prior_sigma
        minsigma = prior_sigma / min(100.0, 1.0 + n)
        sigma = np.clip(sigma, minsigma, maxsigma)
        sigma[prior_pos] = prior_sigma

        if LF and LF < n:
            unsrtd_weights = linear_forgetting_weights(n, LF)
        else:
            unsrtd_weights = np.ones(n)
        srtd_weights = np.insert(unsrtd_weights[order], prior_pos, prior_weight)

    srtd_weights = srtd_weights / srtd_weights.sum()
    return srtd_weights, srtd_mus, sigma


def adaptive_parzen_normal_orig(mus, prior_weight, prior_mu, prior_sigma):
    """Variant without linear forgetting (parity with the reference's
    ``adaptive_parzen_normal_orig``)."""
    return adaptive_parzen_normal(mus, prior_weight, prior_mu, prior_sigma, LF=0)


# ---------------------------------------------------------------------------
# normal helpers
# ---------------------------------------------------------------------------

_SQRT2 = np.sqrt(2.0)


def normal_cdf(x, mu, sigma):
    from scipy.special import erf

    z = (np.asarray(x, dtype=float) - mu) / (np.maximum(sigma, EPS) * _SQRT2)
    return 0.5 * (1.0 + erf(z))


def _normal_logpdf(x, mu, sigma):
    sigma = np.maximum(sigma, EPS)
    z = (x - mu) / sigma
    return -0.5 * z * z - np.log(sigma) - 0.5 * np.log(2 * np.pi)


def _logsumexp(a, axis=None):
    amax = np.max(a, axis=axis, keepdims=True)
    amax = np.where(np.isfinite(amax), amax, 0.0)
    out = np.log(np.sum(np.exp(a - amax), axis=axis)) + np.squeeze(amax, axis=axis)
    return out


def _trunc_normal_sample(rng, mu, sigma, low, high, size):
    """Truncated normal via inverse CDF -- rejection-free by design."""
    mu = np.broadcast_to(mu, size).astype(float)
    sigma = np.maximum(np.broadcast_to(sigma, size).astype(float), EPS)
    if low is None and high is None:
        return rng.normal(mu, sigma)
    a = 0.0 if low is None else normal_cdf(low, mu, sigma)
    b = 1.0 if high is None else normal_cdf(high, mu, sigma)
    u = rng.uniform(size=size)
    p = np.clip(a + u * (b - a), EPS, 1 - EPS)
    x = mu + sigma * ndtri(p)
    if low is not None:
        x = np.maximum(x, low)
    if high is not None:
        x = np.minimum(x, high)
    return x


# ---------------------------------------------------------------------------
# GMM sample / lpdf ops (registered into the pyll scope for parity)
# ---------------------------------------------------------------------------


@scope.define
def GMM1(weights, mus, sigmas, low=None, high=None, q=None, rng=None, size=()):
    """Sample from a (truncated, optionally quantized) 1-D GMM."""
    rng = ensure_rng(rng)
    weights = np.asarray(weights, dtype=float)
    mus = np.asarray(mus, dtype=float)
    sigmas = np.asarray(sigmas, dtype=float)
    size = (size,) if isinstance(size, (int, np.integer)) else tuple(size)
    n = int(np.prod(size)) if size else 1

    ks = rng.choice(len(weights), size=n, p=weights / weights.sum())
    draws = _trunc_normal_sample(rng, mus[ks], sigmas[ks], low, high, (n,))
    if q is not None:
        draws = np.round(draws / q) * q
        if low is not None:
            draws = np.maximum(draws, np.round(low / q) * q)
        if high is not None:
            draws = np.minimum(draws, np.round(high / q) * q)
    if not size:
        return float(draws[0])
    return draws.reshape(size)


@scope.define
def GMM1_lpdf(samples, weights, mus, sigmas, low=None, high=None, q=None):
    """log-density of ``samples`` under a truncated/quantized 1-D GMM."""
    samples = np.asarray(samples, dtype=float)
    nat = _native()
    if nat is not None:
        out = nat.gmm_lpdf(samples.ravel(), weights, mus, sigmas,
                           low=low, high=high, q=q, logspace=False)
        if out is not None:
            return out.reshape(samples.shape)
    return GMM1_lpdf_numpy(samples, weights, mus, sigmas, low=low, high=high,
                           q=q)


def GMM1_lpdf_numpy(samples, weights, mus, sigmas, low=None, high=None, q=None):
    """Pure-numpy GMM1_lpdf (oracle for native/JAX paths)."""
    samples = np.asarray(samples, dtype=float)
    weights = np.asarray(weights, dtype=float)
    mus = np.asarray(mus, dtype=float)
    sigmas = np.maximum(np.asarray(sigmas, dtype=float), EPS)
    x = samples.reshape(-1, 1)  # [S, 1] vs components [K]

    # per-component truncation mass
    a = normal_cdf(low, mus, sigmas) if low is not None else 0.0
    b = normal_cdf(high, mus, sigmas) if high is not None else 1.0
    log_mass = np.log(np.maximum(b - a, EPS))
    logw = np.log(np.maximum(weights / weights.sum(), EPS))

    if q is None:
        ll = logw + _normal_logpdf(x, mus, sigmas) - log_mass
    else:
        ub = x + q / 2.0
        lb = x - q / 2.0
        if low is not None:
            lb = np.maximum(lb, low)
        if high is not None:
            ub = np.minimum(ub, high)
        bin_mass = normal_cdf(ub, mus, sigmas) - normal_cdf(lb, mus, sigmas)
        ll = logw + np.log(np.maximum(bin_mass, EPS)) - log_mass
    rval = _logsumexp(ll, axis=1)
    return rval.reshape(samples.shape)


@scope.define
def LGMM1(weights, mus, sigmas, low=None, high=None, q=None, rng=None, size=()):
    """Sample from a lognormal mixture: ``exp(GMM1-in-log-space)``.

    ``low``/``high`` are bounds in *log* space (matching the reference's
    use for ``loguniform`` priors).
    """
    rng = ensure_rng(rng)
    weights = np.asarray(weights, dtype=float)
    mus = np.asarray(mus, dtype=float)
    sigmas = np.asarray(sigmas, dtype=float)
    size = (size,) if isinstance(size, (int, np.integer)) else tuple(size)
    n = int(np.prod(size)) if size else 1

    ks = rng.choice(len(weights), size=n, p=weights / weights.sum())
    draws = np.exp(_trunc_normal_sample(rng, mus[ks], sigmas[ks], low, high, (n,)))
    if q is not None:
        draws = np.round(draws / q) * q
    if not size:
        return float(draws[0])
    return draws.reshape(size)


@scope.define
def LGMM1_lpdf(samples, weights, mus, sigmas, low=None, high=None, q=None):
    """log-density under a (truncated in log space, optionally quantized)
    lognormal mixture; ``samples`` are in natural space."""
    samples = np.asarray(samples, dtype=float)
    nat = _native()
    if nat is not None:
        out = nat.gmm_lpdf(samples.ravel(), weights, mus, sigmas,
                           low=low, high=high, q=q, logspace=True)
        if out is not None:
            return out.reshape(samples.shape)
    return LGMM1_lpdf_numpy(samples, weights, mus, sigmas, low=low, high=high,
                            q=q)


def LGMM1_lpdf_numpy(samples, weights, mus, sigmas, low=None, high=None,
                     q=None):
    """Pure-numpy LGMM1_lpdf (oracle for native/JAX paths)."""
    samples = np.asarray(samples, dtype=float)
    weights = np.asarray(weights, dtype=float)
    mus = np.asarray(mus, dtype=float)
    sigmas = np.maximum(np.asarray(sigmas, dtype=float), EPS)
    x = samples.reshape(-1, 1)

    a = normal_cdf(low, mus, sigmas) if low is not None else 0.0
    b = normal_cdf(high, mus, sigmas) if high is not None else 1.0
    log_mass = np.log(np.maximum(b - a, EPS))
    logw = np.log(np.maximum(weights / weights.sum(), EPS))

    if q is None:
        logx = np.log(np.maximum(x, EPS))
        ll = logw + _normal_logpdf(logx, mus, sigmas) - logx - log_mass
    else:
        ub = np.log(np.maximum(x + q / 2.0, EPS))
        lb = np.log(np.maximum(x - q / 2.0, EPS))
        if low is not None:
            lb = np.maximum(lb, low)
        if high is not None:
            ub = np.minimum(ub, high)
        bin_mass = normal_cdf(ub, mus, sigmas) - normal_cdf(lb, mus, sigmas)
        ll = logw + np.log(np.maximum(bin_mass, EPS)) - log_mass
    rval = _logsumexp(ll, axis=1)
    return rval.reshape(samples.shape)


def broadcast_best(samples, ll_below, ll_above):
    """Factorized EI argmax: pick the candidate maximizing
    ``log l(x) - log g(x)`` (independently per hyperparameter)."""
    samples = np.asarray(samples)
    score = np.asarray(ll_below) - np.asarray(ll_above)
    return samples[int(np.argmax(score))]


# ---------------------------------------------------------------------------
# categorical posterior
# ---------------------------------------------------------------------------


def categorical_posterior(obs, prior_p, prior_weight, LF):
    """Posterior pmf over categories from weighted counts + prior
    pseudocounts (parity: reference ``ap_categorical_sampler``)."""
    prior_p = np.asarray(prior_p, dtype=float)
    n_options = len(prior_p)
    obs = np.asarray(obs, dtype=int)
    w = linear_forgetting_weights(len(obs), LF)
    counts = np.bincount(obs, weights=w, minlength=n_options)
    pseudocounts = counts + prior_weight * prior_p * n_options
    return pseudocounts / pseudocounts.sum()


# ---------------------------------------------------------------------------
# per-distribution posterior draw (the factorized TPE inner step)
# ---------------------------------------------------------------------------


def _prior_gmm_params(info):
    """Map a ParamInfo to (prior_mu, prior_sigma, low, high, logspace, q)."""
    p = info.params
    d = info.dist
    if d in ("uniform", "quniform"):
        low, high = float(p["low"]), float(p["high"])
        return 0.5 * (low + high), high - low, low, high, False, p.get("q")
    if d in ("loguniform", "qloguniform"):
        low, high = float(p["low"]), float(p["high"])
        return 0.5 * (low + high), high - low, low, high, True, p.get("q")
    if d in ("normal", "qnormal"):
        return float(p["mu"]), float(p["sigma"]), None, None, False, p.get("q")
    if d in ("lognormal", "qlognormal"):
        return float(p["mu"]), float(p["sigma"]), None, None, True, p.get("q")
    raise NotImplementedError(d)


def posterior_draw(info, obs_below, obs_above, rng, prior_weight, n_EI_candidates, LF):
    """Draw the EI-argmax value for one hyperparameter."""
    d = info.dist
    p = info.params

    if d in ("randint", "categorical", "randint_via_categorical"):
        if d == "randint":
            low = int(p["low"])
            n_options = int(p["high"]) - low
            prior_p = np.full(n_options, 1.0 / n_options)
            ob = np.asarray(obs_below, dtype=int) - low
            oa = np.asarray(obs_above, dtype=int) - low
        else:
            low = 0
            prior_p = np.asarray(p["p"], dtype=float)
            ob = np.asarray(obs_below, dtype=int)
            oa = np.asarray(obs_above, dtype=int)
        p_below = categorical_posterior(ob, prior_p, prior_weight, LF)
        p_above = categorical_posterior(oa, prior_p, prior_weight, LF)
        candidates = rng.choice(len(prior_p), size=n_EI_candidates, p=p_below)
        llr = np.log(p_below[candidates]) - np.log(p_above[candidates])
        return int(candidates[int(np.argmax(llr))]) + low

    prior_mu, prior_sigma, low, high, logspace, q = _prior_gmm_params(info)
    q = None if q is None else float(q)
    obs_below = np.asarray(obs_below, dtype=float)
    obs_above = np.asarray(obs_above, dtype=float)
    if logspace:
        fit_below = np.log(np.maximum(obs_below, EPS)) if len(obs_below) else obs_below
        fit_above = np.log(np.maximum(obs_above, EPS)) if len(obs_above) else obs_above
    else:
        fit_below, fit_above = obs_below, obs_above

    wb, mb, sb = adaptive_parzen_normal(fit_below, prior_weight, prior_mu, prior_sigma, LF)
    wa, ma, sa = adaptive_parzen_normal(fit_above, prior_weight, prior_mu, prior_sigma, LF)

    if logspace:
        samples = LGMM1(wb, mb, sb, low=low, high=high, q=q, rng=rng,
                        size=(n_EI_candidates,))
        ll_below = LGMM1_lpdf(samples, wb, mb, sb, low=low, high=high, q=q)
        ll_above = LGMM1_lpdf(samples, wa, ma, sa, low=low, high=high, q=q)
    else:
        samples = GMM1(wb, mb, sb, low=low, high=high, q=q, rng=rng,
                       size=(n_EI_candidates,))
        ll_below = GMM1_lpdf(samples, wb, mb, sb, low=low, high=high, q=q)
        ll_above = GMM1_lpdf(samples, wa, ma, sa, low=low, high=high, q=q)
    return float(broadcast_best(samples, ll_below, ll_above))


# Registry {dist name -> posterior draw}: the plugin surface the reference
# exposes as ``adaptive_parzen_samplers``.
adaptive_parzen_samplers = {
    name: posterior_draw
    for name in (
        "uniform", "quniform", "loguniform", "qloguniform",
        "normal", "qnormal", "lognormal", "qlognormal",
        "randint", "categorical", "randint_via_categorical",
    )
}


# ---------------------------------------------------------------------------
# good/bad split
# ---------------------------------------------------------------------------


def ap_filter_trials(trials, gamma, LF):
    """Completed ok-trials sorted by (loss, tid) -> (below_docs, above_docs).

    ``n_below = min(ceil(gamma * sqrt(n)), LF)``.
    """
    ok = [t for t in trials.trials if posterior_state(t) == "ok"]
    ok.sort(key=lambda t: (float(t["result"]["loss"]), t["tid"]))
    n_below = min(int(np.ceil(gamma * np.sqrt(len(ok)))), LF)
    below = ok[:n_below]
    above = ok[n_below:]
    # time order within each side (parzen weights are time-indexed)
    below.sort(key=lambda t: t["tid"])
    above.sort(key=lambda t: t["tid"])
    return below, above


ap_split_trials = ap_filter_trials  # reference exposes both names


def _obs_by_label(docs, labels):
    obs = {label: [] for label in labels}
    for t in docs:
        vals = t["misc"]["vals"]
        for label in labels:
            v = vals.get(label, [])
            if len(v) == 1:
                obs[label].append(v[0])
    return obs


class _ObsIndex:
    """Incremental columnar mirror of completed-ok trials (host path).

    Profiling showed ~40% of a host suggest in re-extracting per-label
    observation lists from every trial doc (``ap_filter_trials`` +
    ``_obs_by_label``); this index scans each doc once and answers the
    (loss, tid)-sorted below/above split with numpy selections, with
    EXACTLY the reference semantics (same split, per-side tid order).
    Docs scanned while pending (the shared
    :func:`hyperopt_tpu_torch.base.posterior_state` classification) are
    revisited -- a late completion (the async-backend pattern) is simply
    appended, since :meth:`split_obs` derives every ordering from
    (loss, tid) sorts and row order is irrelevant.
    """

    def __init__(self, labels):
        self.labels = tuple(labels)
        self.reset()

    def reset(self):
        self.n_scanned = 0
        self.pending = []
        self.tids = []
        self.losses = []
        self.label_pos = {lb: [] for lb in self.labels}
        self.label_vals = {lb: [] for lb in self.labels}
        self._frozen = None

    def _add(self, t):
        pos = len(self.tids)
        self.tids.append(int(t["tid"]))
        self.losses.append(float(t["result"]["loss"]))
        vals = t["misc"]["vals"]
        for lb in self.labels:
            v = vals.get(lb, [])
            if len(v) == 1:
                self.label_pos[lb].append(pos)
                self.label_vals[lb].append(v[0])

    def sync(self, trials):
        docs = trials.trials
        if len(docs) < self.n_scanned:
            self.reset()
        grew = False
        still = []
        for i in self.pending:
            t = docs[i]
            ps = posterior_state(t)
            if ps == "ok":
                # late completion: APPEND is enough -- split_obs derives
                # every ordering from (loss, tid) sorts, so row order in
                # the columnar store is irrelevant
                self._add(t)
                grew = True
            elif ps == "pending":
                still.append(i)
        self.pending = still
        for i in range(self.n_scanned, len(docs)):
            t = docs[i]
            ps = posterior_state(t)
            if ps == "ok":
                self._add(t)
                grew = True
            elif ps == "pending":
                self.pending.append(i)
        self.n_scanned = len(docs)
        if grew:
            self._frozen = None
        return self

    def arrays(self):
        if self._frozen is None:
            self._frozen = (
                np.asarray(self.tids, dtype=np.int64),
                np.asarray(self.losses, dtype=np.float64),
                {
                    lb: np.asarray(p, dtype=np.int64)
                    for lb, p in self.label_pos.items()
                },
            )
        return self._frozen

    def split_obs(self, gamma, LF):
        """(obs_below, obs_above) per label -- reference-exact:
        (loss, tid)-sorted split, each side's observations in tid order."""
        tids, losses, label_pos = self.arrays()
        n_ok = len(tids)
        n_below = min(int(np.ceil(gamma * np.sqrt(n_ok))), int(LF))
        order = np.lexsort((tids, losses))  # by loss, ties by tid
        sides = []
        for pos in (order[:n_below], order[n_below:]):
            pos = pos[np.argsort(tids[pos], kind="stable")]  # tid order
            rank = np.full(n_ok, -1, dtype=np.int64)
            rank[pos] = np.arange(len(pos), dtype=np.int64)
            side = {}
            for lb in self.labels:
                lp = label_pos[lb]
                r = rank[lp] if len(lp) else np.empty(0, dtype=np.int64)
                sel = np.flatnonzero(r >= 0)
                sel = sel[np.argsort(r[sel], kind="stable")]
                vals = self.label_vals[lb]
                side[lb] = [vals[int(j)] for j in sel]
            sides.append(side)
        return sides[0], sides[1]


def _obs_index_for(domain, trials, labels):
    """Per-(domain, trials-store) cached index: a Domain reused across
    two Trials stores must never serve one store's observations for the
    other (the stateless pre-index host path was immune by construction,
    so the cache keys on the store's identity via a weakref)."""
    import weakref

    cache = getattr(domain, "_host_obs_index", None)
    idx = None
    if cache is not None:
        ref, idx_cached = cache
        if ref() is trials and idx_cached.labels == tuple(labels):
            idx = idx_cached
    if idx is None:
        idx = _ObsIndex(labels)
        domain._host_obs_index = (weakref.ref(trials), idx)
    return idx.sync(trials)


# ---------------------------------------------------------------------------
# suggest
# ---------------------------------------------------------------------------


def _posterior_draws(domain, trials, rng, prior_weight, n_EI_candidates, gamma, LF):
    """Unrouted per-label posterior EI-argmax draws (every label, whether
    or not it ends up active)."""
    helper = _domain_helper(domain)
    hps = helper.hps
    labels = sorted(hps)

    obs_below, obs_above = _obs_index_for(domain, trials, labels).split_obs(
        gamma, LF
    )

    return {
        label: posterior_draw(
            hps[label],
            obs_below[label],
            obs_above[label],
            rng,
            prior_weight,
            n_EI_candidates,
            LF,
        )
        for label in labels
    }


def _route_draws(domain, draws):
    """Route draws through the space graph: only labels on the chosen
    branches survive into the trial's active config."""
    helper = _domain_helper(domain)
    memo = {info.node: draws[label] for label, info in helper.hps.items()}
    active = {}

    def observer(node, value):
        if node.name == "hyperopt_param":
            active[node.pos_args[0].obj] = value

    rec_eval(domain.expr, memo=memo, observer=observer)
    return active


def _suggest_config(domain, trials, rng, prior_weight, n_EI_candidates, gamma, LF):
    """One new config: posterior EI-argmax per hyperparameter, activity
    routed through the space graph (factorized TPE)."""
    draws = _posterior_draws(
        domain, trials, rng, prior_weight, n_EI_candidates, gamma, LF
    )
    return _route_draws(domain, draws)


def suggest_batch(
    new_ids,
    domain,
    trials,
    seed,
    prior_weight=_default_prior_weight,
    n_startup_jobs=_default_n_startup_jobs,
    n_EI_candidates=_default_n_EI_candidates,
    gamma=_default_gamma,
    linear_forgetting=_default_linear_forgetting,
):
    """Sparse (idxs, vals) for a batch of new ids via TPE."""
    rng = ensure_rng(seed)
    helper = _domain_helper(domain)
    labels = sorted(helper.hps)
    idxs = {label: [] for label in labels}
    vals = {label: [] for label in labels}

    n_ok = len(
        [
            t
            for t in trials.trials
            if t["state"] == JOB_STATE_DONE and t["result"].get("status") == STATUS_OK
        ]
    )
    for tid in new_ids:
        if n_ok < n_startup_jobs:
            config = helper.sample_one(rng)
        else:
            config = _suggest_config(
                domain, trials, rng, prior_weight, n_EI_candidates, gamma,
                linear_forgetting,
            )
        for label, value in config.items():
            idxs[label].append(tid)
            vals[label].append(value)
    return idxs, vals


def suggest(
    new_ids,
    domain,
    trials,
    seed,
    prior_weight=_default_prior_weight,
    n_startup_jobs=_default_n_startup_jobs,
    n_EI_candidates=_default_n_EI_candidates,
    gamma=_default_gamma,
    linear_forgetting=_default_linear_forgetting,
    verbose=True,
):
    """The plugin-boundary entry point: ``algo=hyperopt_tpu_torch.tpe_host.suggest``."""
    idxs, vals = suggest_batch(
        new_ids,
        domain,
        trials,
        seed,
        prior_weight=prior_weight,
        n_startup_jobs=n_startup_jobs,
        n_EI_candidates=n_EI_candidates,
        gamma=gamma,
        linear_forgetting=linear_forgetting,
    )
    return docs_from_idxs_vals(new_ids, domain, trials, idxs, vals)
