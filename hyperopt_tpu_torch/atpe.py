"""Adaptive TPE on the card: ``algo=hyperopt_tpu_torch.atpe.suggest``.

The counterpart of :mod:`hyperopt_tpu.atpe_jax`, with the port's copy of
the decision layer it uses, :class:`hyperopt_tpu.atpe.ATPEOptimizer`
(``tpe_settings``, ``locked_values``, ``lock_candidates``):

* :func:`suggest` takes the optimizer's per-step TPE settings (gamma,
  candidate count, prior weight) and its lock set from host statistics
  of the history, draws through :func:`hyperopt_tpu_torch.tpe.
  suggest_dense` on the domain's device (one ``gmm_llr`` launch per warm
  ask), and rolls restarts and locks per suggestion with the seed's rng;
* :func:`build_atpe_device_fn` is the same decisions as tensor ops over
  the history (the body of the reference's compiled device loop): the
  settings and the lock set stay on the device, no host sync.

Both shard the candidate sweep over a mesh's ``cand`` axis on request
(``suggest(mesh=)``, ``build_atpe_device_fn(mesh=, cand_axis=)``), through
:mod:`hyperopt_tpu_torch.parallel.sharded`: the adapted candidate count
is the TOTAL over the ranks.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from . import random as R
from . import tpe
from .base import posterior_state
from .ops import kernels as K
from .pyll.stochastic import ensure_rng
from .rand import _domain_helper, docs_from_idxs_vals
from .torch_trials import obs_buffer_for, packed_space_for
from .vectorize import dense_to_idxs_vals

logger = logging.getLogger(__name__)

__all__ = ["ATPEOptimizer", "build_atpe_device_fn", "suggest"]

# the largest gamma the adaptive schedule can produce: the static pad of
# the compacted below set handed to fit_all_dims
_MAX_ADAPTIVE_GAMMA = 0.35

# the categorical dim family as named by the domain helper's dist field
CAT_DISTS = ("randint", "categorical", "randint_via_categorical")
_LOG_DISTS = ("loguniform", "qloguniform", "lognormal", "qlognormal")

def _ok_trials(trials):
    return [t for t in trials.trials if posterior_state(t) == "ok"]


def _pure_categorical(domain):
    """Every dim categorical-family: the regime where ATPE's heuristics
    emit plain TPE settings and never lock."""
    ps = packed_space_for(domain)
    return ps.n_dims > 0 and len(ps.cat_idx) == ps.n_dims


class ATPEOptimizer:
    """Derives per-step TPE settings and a lock set from the history.

    ``base_n_ei`` anchors the adaptive candidate count at the caller's
    default; adaptation may only raise it.  (The reference's
    ``suggest_config``, which drives its numpy host TPE, is not here.)
    """

    def __init__(self, lock_fraction=0.5, elite_count=8, meta_model=None,
                 base_n_ei=24):
        self.lock_fraction = lock_fraction
        self.elite_count = elite_count
        self.meta_model = meta_model  # optional (n_dims, ...) -> settings scorer
        self.base_n_ei = int(base_n_ei)

    def tpe_settings(self, domain, trials):
        """``gamma``, ``n_EI_candidates``, ``prior_weight``,
        ``n_EI_candidates_cat`` and ``explore_fraction`` for this step:
        wider spaces take a larger elite fraction and more continuous
        candidates; a stalled history (the best loss gained at most 2%
        of its total gain over the last ``min(15, n // 2)`` trials)
        boosts the prior to 1.5 and sends a quarter of the suggestions
        to pure prior draws; an improving one sharpens gamma by 0.05."""
        ps = packed_space_for(domain)
        n_dims = ps.n_dims
        frac_cat = len(ps.cat_idx) / max(n_dims, 1)
        ok = _ok_trials(trials)
        n = len(ok)

        explore_fraction = 0.0
        if _pure_categorical(domain):
            gamma, n_ei, prior_weight = 0.25, self.base_n_ei, 1.0
        else:
            gamma = float(np.clip(0.20 + 0.01 * n_dims, 0.15, 0.35))
            n_ei = int(np.clip(
                self.base_n_ei * (1 + n_dims / 20),
                self.base_n_ei, max(256, 2 * self.base_n_ei),
            ))
            prior_weight = 1.0
            if n >= 20:
                losses = [float(t["result"]["loss"]) for t in ok]
                best_first = np.minimum.accumulate(losses)
                w = min(15, max(2, n // 2))
                recent_gain = best_first[-w] - best_first[-1]
                total_gain = best_first[0] - best_first[-1]
                if recent_gain <= 0.02 * (total_gain + 1e-12):
                    prior_weight = 1.5
                    explore_fraction = 0.25
                else:
                    gamma = max(0.15, gamma - 0.05)

        if self.meta_model is not None:
            try:  # optional learned override
                gamma, n_ei, prior_weight = self.meta_model(
                    n_dims, frac_cat, n, gamma, n_ei, prior_weight
                )
            except Exception as e:  # pragma: no cover
                logger.warning("meta_model failed, using heuristics: %s", e)

        return {
            "gamma": gamma,
            "n_EI_candidates": n_ei,
            "prior_weight": prior_weight,
            "n_EI_candidates_cat": tpe._default_n_EI_candidates_cat,
            "explore_fraction": explore_fraction,
        }

    def locked_values(self, domain, trials, rng):
        """{label: value} of converged hyperparameters to freeze this step."""
        if rng.uniform() > self.lock_fraction:
            return {}
        return self.lock_candidates(domain, trials)

    def lock_candidates(self, domain, trials):
        """Which labels have converged across the elite set, and to what
        value: categorical labels whose modal share is at least 0.8,
        continuous ones whose (latent) spread is under 5% of the prior
        width.  At most half the space's labels lock, the most converged
        first; pure-categorical spaces and histories under 20 never lock.
        """
        ok = _ok_trials(trials)
        if len(ok) < 20:
            return {}
        ok.sort(key=lambda t: float(t["result"]["loss"]))
        elite = ok[: self.elite_count]
        if _pure_categorical(domain):
            return {}
        helper = _domain_helper(domain)
        locked = {}  # label -> (convergence score in (0, 1], value)
        for label, info in helper.hps.items():
            vals = [
                t["misc"]["vals"][label][0]
                for t in elite
                if len(t["misc"]["vals"].get(label, [])) == 1
            ]
            if len(vals) < max(3, len(elite) // 2):
                continue
            if info.dist in CAT_DISTS:
                uniq, counts = np.unique(np.asarray(vals, dtype=int), return_counts=True)
                share = counts.max() / counts.sum()
                if share >= 0.8:
                    locked[label] = ((share - 0.8) / 0.2, int(uniq[np.argmax(counts)]))
            else:
                arr = np.asarray(vals, dtype=float)
                p = info.params
                if info.dist in _LOG_DISTS:
                    arr = np.log(np.maximum(arr, 1e-300))
                if "low" in p and isinstance(p.get("low"), (int, float)):
                    width = float(p["high"]) - float(p["low"])
                else:
                    width = 2.0 * float(p.get("sigma", 1.0))
                if width > 0 and arr.std() < 0.05 * width:
                    v = float(np.median(arr))
                    if info.dist.startswith("q") and isinstance(p.get("q"), (int, float)):
                        q = float(p["q"])
                        v = float(np.round(v / q) * q)
                    if info.dist in _LOG_DISTS:
                        v = float(np.exp(v))
                    locked[label] = (1.0 - float(arr.std()) / (0.05 * width), v)
        max_lock = len(helper.hps) // 2
        if max_lock == 0:
            return {}
        if len(locked) > max_lock:
            keep = sorted(locked, key=lambda k: -locked[k][0])[:max_lock]
            locked = {k: locked[k] for k in keep}
        return {k: v for k, (_, v) in locked.items()}


def build_atpe_device_fn(ps, lf, prior_weight=1.0, elite_count=8,
                         lock_fraction=0.5, base_n_ei=None, n_cand_cat=None,
                         mesh=None, cand_axis=None, above_cap=None):
    """The adaptive TPE suggest step for a PackedSpace, every decision on
    the device: ``fn(key, values, active, losses, valid, batch) ->
    (new_values [D, B], new_active [D, B])``.

    * Shape decisions are taken here, on the host: the candidate count
      ``clip(base * (1 + D/20), base, max(256, 2*base))``, the base gamma
      ``clip(0.20 + 0.01 D, 0.15, 0.35)``, and the pure-categorical
      regime (plain TPE settings, no restarts, no locks).
    * Per-step decisions are 0-dim tensors of the history: the stall
      detector of :meth:`ATPEOptimizer.tpe_settings` sets the prior
      weight to 1.5 and a 0.25 restart fraction when stalled and sharpens
      gamma by 0.05 when improving; they reach :func:`~hyperopt_tpu_torch.
      ops.kernels.fit_all_dims` as tensors, so no value is read back.
    * Locking is a masked reduction over the elite set (latent std under
      5% of the prior width; categorical modal share at least 0.8), capped
      at D//2 keeping the most converged, applied per suggestion column
      with probability ``lock_fraction`` (restart columns skip it); then
      the activity is derived again, so a locked choice re-routes.

    The key tree is the reference's: ``split(key, 3)`` into the sweep,
    prior and roll keys, then ``split(k_roll)`` into the restart and
    lock rolls.  Keys ``[S, 2]`` with a history of the same leading axis
    (``values [S, D, cap]``) run S experiments at once, the seed sweep of
    the compiled loop: seed ``s``'s slice is computed by the same
    operations as its solo call.

    ``mesh``/``cand_axis`` shard the EI candidate sweep over the mesh's
    ranks (:func:`hyperopt_tpu_torch.parallel.sharded.build_sharded_sweep`
    over the fits computed here): the adapted candidate count stays the
    TOTAL sweep width, each rank drawing ``ceil(total / ranks)``.  The
    settings and the lock set do not depend on the ranks, so the sharded
    and unsharded steps differ only in the sweep's key folding.  With a
    ``cand_axis`` the step also has two halves, ``fn.local(key, values,
    active, losses, valid, batch, rank)`` (the settings, the fits and the
    rank's packed winners, then the settings the rolls read) and
    ``fn.reduce(key, values, active, losses, valid, batch, gathered,
    ctx)`` (the argmax over the ranks' winners, the restarts and the
    locks): the compiled loop's step over processes, with the host
    gather of the winners between two captured graphs.
    """
    K.check_prior_weight(prior_weight)
    if base_n_ei is None:
        base_n_ei = tpe._default_n_EI_candidates
    if n_cand_cat is None:
        n_cand_cat = tpe._default_n_EI_candidates_cat
    a_cap = tpe._resolve_above_cap(above_cap)
    c = ps.consts
    D = ps.n_dims
    Dc = len(ps.cont_idx)
    Dk = len(ps.cat_idx)
    dev = ps.device
    pure_categorical = D > 0 and Dk == D
    lf_f = float(lf)
    pw0 = float(prior_weight)
    E = int(elite_count)
    lock_fraction = float(lock_fraction)

    if pure_categorical:
        base_gamma = 0.25
        n_ei = int(base_n_ei)
    else:
        base_gamma = float(np.clip(0.20 + 0.01 * D, 0.15, _MAX_ADAPTIVE_GAMMA))
        n_ei = int(np.clip(base_n_ei * (1 + D / 20), base_n_ei, max(256, 2 * base_n_ei)))
    n_cat = max(1, int(n_cand_cat))

    sharded_sweep = None
    if cand_axis is not None:
        if mesh is None:
            raise ValueError("cand_axis requires a mesh")
        from .parallel.sharded import build_sharded_sweep, per_device_count

        n_ranks = int(mesh.shape[cand_axis])
        sharded_sweep = build_sharded_sweep(
            ps, mesh, per_device_count(n_ei, n_ranks), axis=cand_axis,
            n_cand_cat_per_device=per_device_count(n_cat, n_ranks))

    # per-cont-dim latent prior width for lock convergence (bounded dims:
    # high - low; unbounded: 2 sigma)
    width = None
    if Dc:
        width = torch.tensor(np.where(
            np.isfinite(ps.low) & np.isfinite(ps.high), ps.high - ps.low, 2.0 * ps.prior_sigma,
        ).astype(np.float32), device=dev)
    m_min = max(3, E // 2)  # fewest elite observations a dim is judged on
    max_lock = D // 2
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    base_gamma_t, sharp_gamma_t = f32(base_gamma), f32(max(0.15, base_gamma - 0.05))
    pw0_t, pw_stalled_t = f32(pw0), f32(1.5)
    explore_t, no_explore_t = f32(0.25), f32(0.0)
    arange_d = torch.arange(D, dtype=torch.int64, device=dev)

    def settings(losses, valid):
        """(gamma, prior_weight, explore_fraction, ok, n) as tensors over
        the history's leading dims (none, or a seed axis)."""
        ok = valid & torch.isfinite(losses)
        # integer counts: exact in any order, in the fixed order all the same
        n = K.sum_rows(ok.to(torch.int64), dim=-1)
        best_first = torch.cummin(torch.where(ok, losses, torch.inf), dim=-1).values
        cnt = K.cumsum_rows(ok.to(torch.int64), dim=-1)

        def at_ok(k):  # best-so-far after the k-th ok trial (1-indexed)
            slot = torch.clamp(torch.searchsorted(cnt, k[..., None]), 0, losses.shape[-1] - 1)
            # a gather, not best_first[slot[0]]: indexing by a tensor
            # element reads it on the host, which a captured step cannot
            return torch.gather(best_first, -1, slot)[..., 0]

        w = torch.clamp(torch.clamp(n // 2, min=2), max=15)
        # best_first[-w] of the host is the best after the (n-w+1)-th ok
        # trial, so the gain spans w-1 trials
        recent_gain = at_ok(n - w + 1) - at_ok(n)
        total_gain = at_ok(torch.ones_like(n)) - at_ok(n)
        judged = n >= 20
        stalled = judged & (recent_gain <= 0.02 * (total_gain + 1e-12))
        improving = judged & ~stalled
        gamma = torch.where(improving, sharp_gamma_t, base_gamma_t)
        pw = torch.where(stalled, pw_stalled_t, pw0_t)
        explore = torch.where(stalled, explore_t, no_explore_t)
        return gamma, pw, explore, ok, n

    def lock_set(values, active, losses, ok, n):
        """(lock_mask [..., D], lock_vals [..., D]) over the elite set.
        The float sums along the history go through
        :func:`~hyperopt_tpu_torch.ops.kernels.sum_rows`, so on the card a
        seed's slice of a stacked history carries its solo bits."""
        lead = losses.shape[:-1]
        order = torch.argsort(torch.where(ok, losses, torch.inf), dim=-1, stable=True)
        elite = torch.zeros_like(ok).scatter_(-1, order[..., :E], True)
        elite = elite & ok
        judged = (n >= 20)[..., None]

        scores = torch.full(lead + (D,), -torch.inf, dtype=torch.float32, device=dev)
        lock_vals = torch.zeros(lead + (D,), dtype=torch.float32, device=dev)

        if Dc:
            cont_idx = c["cont_idx"]
            logspace = c["logspace"]
            obs = values[..., cont_idx, :]
            lat = torch.where(logspace[:, None], K._safe_log(obs), obs)
            elig = active[..., cont_idx, :] & elite[..., None, :]
            w = elig.to(torch.float32)
            m = K.sum_rows(w, dim=-1)
            m_safe = torch.clamp(m, min=1.0)
            mean = K.sum_rows(lat * w, dim=-1) / m_safe
            var = K.sum_rows((lat - mean[..., None]) ** 2 * w, dim=-1) / m_safe
            std = torch.sqrt(torch.clamp(var, min=0.0))
            thr = 0.05 * width
            # masked median, as np.median (mean of the middle two)
            svals, _ = torch.sort(torch.where(elig, lat, torch.inf), dim=-1)
            mi = torch.clamp(m.to(torch.int64) - 1, min=0)
            lo = torch.gather(svals, -1, (mi // 2)[..., None])[..., 0]
            hi = torch.gather(svals, -1, ((mi + 1) // 2)[..., None])[..., 0]
            med_lat = 0.5 * (lo + hi)
            nat = torch.where(logspace, torch.exp(med_lat), med_lat)
            nat = K.quantize_nat(nat, c["q"], c["low"], c["high"], logspace)
            locked = (m >= m_min) & (width > 0) & (std < thr) & judged
            scores[..., cont_idx] = torch.where(
                locked, 1.0 - std / torch.clamp(thr, min=1e-30), -torch.inf)
            lock_vals[..., cont_idx] = nat

        if Dk:
            cat_idx = c["cat_idx"]
            obs_k = values[..., cat_idx, :] - c["int_low"][:, None]
            elig = active[..., cat_idx, :] & elite[..., None, :]
            w = elig.to(torch.float32)
            m = K.sum_rows(w, dim=-1)
            cats = torch.arange(int(ps.k_max), dtype=obs_k.dtype, device=dev)
            onehot = (obs_k[..., None] == cats).to(torch.float32)
            counts = K.sum_rows(onehot * w[..., None], dim=-2)  # [..., Dk, K]
            share = torch.amax(counts, dim=-1) / torch.clamp(m, min=1.0)
            mode = torch.argmax(counts, dim=-1).to(torch.float32)
            locked = (m >= m_min) & (share >= 0.8) & judged
            scores[..., cat_idx] = torch.where(locked, (share - 0.8) / 0.2, -torch.inf)
            lock_vals[..., cat_idx] = mode + c["int_low"].to(torch.float32)

        if max_lock == 0:  # 1-dim spaces never lock
            return torch.zeros(lead + (D,), dtype=torch.bool, device=dev), lock_vals
        # cap at D//2, keeping the most converged (stable order among ties)
        order_s = torch.argsort(-scores, dim=-1, stable=True)
        rank = torch.empty_like(order_s).scatter_(-1, order_s, arange_d.expand_as(order_s))
        return torch.isfinite(scores) & (rank < max_lock), lock_vals

    def decide(key, values, active, losses, valid):
        """The step's keys, the fits and what the column rolls read (the
        settings' explore fraction, ``ok`` and ``n``; none on a
        pure-categorical space)."""
        k_tpe, k_prior, k_roll = R.split(key, 3).unbind(-2)
        if pure_categorical:
            # plain TPE settings: a boosted prior would flatten the
            # posterior that is the exploitation mechanism there
            gamma, pw, ctx = base_gamma, pw0, ()
        else:
            gamma, pw, explore_frac, ok, n = settings(losses, valid)
            ctx = (explore_frac, ok, n)
        fits = K.fit_all_dims(c, values, active, losses, valid, gamma, lf_f, pw,
                              pad_gamma=_MAX_ADAPTIVE_GAMMA, above_cap=a_cap)
        return k_tpe, k_prior, k_roll, fits, ctx

    def finish(k_prior, k_roll, values, active, losses, new_values, ctx, batch):
        """The swept columns -> ``(new_values, active)``: stall restarts and
        converged-parameter locks."""
        if pure_categorical:
            return new_values, ps.active_fn(new_values)
        explore_frac, ok, n = ctx
        # stall-triggered restarts: whole columns become prior draws
        prior_vals, _ = ps.sample_prior_fn(k_prior, batch)
        k_explore, k_lock = R.split(k_roll).unbind(-2)
        explore_col = R.uniform(k_explore, (batch,)) < explore_frac[..., None]
        new_values = torch.where(explore_col[..., None, :], prior_vals, new_values)

        # converged-parameter locks, rolled per column; restarts skip them
        lock_mask, lock_vals = lock_set(values, active, losses, ok, n)
        lock_col = (R.uniform(k_lock, (batch,)) < lock_fraction) & ~explore_col
        apply = lock_mask[..., :, None] & lock_col[..., None, :]
        new_values = torch.where(apply, lock_vals[..., :, None], new_values)
        return new_values, ps.active_fn(new_values)

    def fn(key, values, active, losses, valid, batch):
        lead = key.shape[:-1]  # () for one history, (S,) for a seed sweep
        k_tpe, k_prior, k_roll, fits, ctx = decide(key, values, active, losses, valid)
        if sharded_sweep is not None:
            new_values, _ = sharded_sweep(k_tpe, fits, batch)
        else:
            new_values = _sweep(k_tpe, fits, lead, batch)
        return finish(k_prior, k_roll, values, active, losses, new_values, ctx, batch)

    def local(key, values, active, losses, valid, batch, rank):
        """The first half of the step split at the packed winners: this
        rank's winners, then what :func:`finish` reads."""
        k_tpe, _, _, fits, ctx = decide(key, values, active, losses, valid)
        return (sharded_sweep.local(k_tpe, fits, batch, rank),) + ctx

    def reduce(key, values, active, losses, valid, batch, gathered, ctx):
        """The second half: every rank's winners, reduced, then the
        restarts and locks over the first half's settings ``ctx``."""
        _, k_prior, k_roll = R.split(key, 3).unbind(-2)
        new_values, _ = sharded_sweep.reduce(gathered)
        return finish(k_prior, k_roll, values, active, losses, new_values, ctx, batch)

    def _sweep(k_tpe, fits, lead, batch):
        """The unsharded sweep: every dim's best of ``n_ei`` (``n_cat``)
        candidates."""
        new_values = torch.zeros(lead + (D, batch), dtype=torch.float32, device=dev)
        keys = R.split(k_tpe, max(batch * (Dc + Dk), 1))
        if fits["cont"] is not None:
            cont_keys = keys[..., : batch * Dc, :].reshape(lead + (batch, Dc, 2))
            cont_vals, _ = K.ei_sweep_cont(ps.q, c, cont_keys, fits["cont"], n_ei)
            new_values[..., c["cont_idx"], :] = cont_vals.transpose(-1, -2)
        if fits["cat"] is not None:
            pb, pa = fits["cat"]
            if lead:  # a seed's posteriors broadcast against its trial axis
                pb, pa = pb.unsqueeze(len(lead)), pa.unsqueeze(len(lead))
            cat_keys = keys[..., batch * Dc: batch * (Dc + Dk), :].reshape(lead + (batch, Dk, 2))
            cat_vals, _ = K.ei_sweep_cat(cat_keys, pb, pa, n_cat)
            new_values[..., c["cat_idx"], :] = cat_vals.transpose(-1, -2) + c["int_low"][:, None]
        return new_values

    # the two decision stages, for inspection: settings(losses, valid) and
    # lock_set(values, active, losses, ok, n)
    fn.settings, fn.lock_set = settings, lock_set
    if sharded_sweep is not None:
        # the step split at the packed winners (parallel.sharded)
        fn.local, fn.reduce = local, reduce
    return fn


def _optimizer_for(domain, lock_fraction, elite_count):
    opt = getattr(domain, "_atpe_torch_optimizer", None)
    if (opt is None or opt.lock_fraction != lock_fraction
            or opt.elite_count != elite_count):
        # anchor the adaptive candidate count at the device path's
        # default: adaptation may only raise it
        opt = ATPEOptimizer(lock_fraction=lock_fraction, elite_count=elite_count,
                            base_n_ei=tpe._default_n_EI_candidates)
        domain._atpe_torch_optimizer = opt
    return opt


def _sharded_dense(domain, buf, seed, batch, mesh, kw, linear_forgetting):
    """The warm draw with the candidate sweep sharded over ``mesh``'s
    ``cand`` axis: the optimizer's per-step settings feed
    :func:`hyperopt_tpu_torch.parallel.sharded.sharded_draw`, whose built
    step is cached per settings tuple (gamma and the prior weight take two
    adaptive values each, so at most four builds per mesh)."""
    from .parallel.mesh import CAND_AXIS
    from .parallel.sharded import per_device_count, sharded_draw

    ps = packed_space_for(domain)
    key = R.key(int(seed) % (2**31 - 1), device=ps.device)
    n_ranks = int(mesh.shape[CAND_AXIS])
    return sharded_draw(
        domain, buf, mesh, "_atpe_sharded_cache",
        per_device_count(kw["n_EI_candidates"], n_ranks), kw["gamma"], linear_forgetting,
        kw["prior_weight"], per_device_count(kw["n_EI_candidates_cat"], n_ranks), key, batch,
        above_cap=kw.get("above_cap"),
    )


def _dense_draw(domain, trials, opt, rng, batch, n_startup_jobs, linear_forgetting,
                mesh=None):
    """The adaptive draw for a batch: the device sweep under the
    optimizer's per-step settings (sharded over ``mesh`` when given), then
    per-column restart/lock rolls."""
    ps = packed_space_for(domain)
    buf = obs_buffer_for(domain, trials)
    warm = buf.count >= n_startup_jobs

    kw = {}
    explore_fraction = 0.0
    if warm:
        kw = dict(opt.tpe_settings(domain, trials))
        explore_fraction = kw.pop("explore_fraction", 0.0)
    if warm and mesh is not None:
        values, active = _sharded_dense(domain, buf, int(rng.integers(0, 2**31 - 1)), batch,
                                        mesh, kw, linear_forgetting)
    else:
        values, active = tpe.suggest_dense(
            domain, trials, int(rng.integers(0, 2**31 - 1)), batch,
            n_startup_jobs=n_startup_jobs, linear_forgetting=linear_forgetting, **kw,
        )
    values = np.array(values)

    if warm:
        pos = {label: d for d, label in enumerate(ps.labels)}
        cands = opt.lock_candidates(domain, trials)  # invariant per call
        helper = _domain_helper(domain) if explore_fraction else None
        rerouted = False
        for j in range(batch):  # per-suggestion rolls
            if explore_fraction and rng.uniform() < explore_fraction:
                # restart: a pure prior draw from the host sampler; locks
                # are skipped (a restart keeping converged values is not one)
                for label, v in helper.sample_one(rng).items():
                    values[pos[label], j] = float(v)
                rerouted = True
                continue
            if not cands or rng.uniform() > opt.lock_fraction:
                continue
            for label, v in cands.items():
                d = pos.get(label)
                if d is not None:
                    values[d, j] = float(v)
                    rerouted = True
        if rerouted:
            # restarts/locks may re-route choice subtrees
            active = ps.active_fn(torch.as_tensor(values, device=ps.device)).cpu().numpy()
    return values, active


def suggest(
    new_ids,
    domain,
    trials,
    seed,
    n_startup_jobs=20,
    linear_forgetting=25,
    lock_fraction=0.5,
    elite_count=8,
    speculative=0,
    max_stale=None,
    mesh=None,
    resident=None,
):
    """The plugin-boundary entry point: ``algo=hyperopt_tpu_torch.atpe.suggest``.

    ``speculative=k`` serves k sequential asks from one k-wide draw (the
    settings and the lock set refresh at every redraw); on a saturated
    pure-categorical space it stays off, with a one-time warning.
    ``resident=True`` keeps the history on the device: the sweep goes
    through :func:`hyperopt_tpu_torch.tpe.suggest_dense`, so its warm
    draws take the O(D) delta tells and fused asks unchanged.
    ``mesh`` (a :class:`~hyperopt_tpu_torch.parallel.mesh.RankMesh` with a
    ``cand`` axis, e.g. ``virtual_mesh(4)``) shards the warm draws'
    candidate sweep over its ranks, the adaptive candidate count being the
    TOTAL over them, as :func:`hyperopt_tpu_torch.parallel.sharded.
    sharded_suggest` does for plain TPE.
    """
    rng = ensure_rng(seed)
    opt = _optimizer_for(domain, lock_fraction, elite_count)
    ps = packed_space_for(domain)
    if resident is not None:
        obs_buffer_for(domain, trials, resident=bool(resident))
    B = len(new_ids)

    if speculative and B == 1 and tpe._saturated_categorical(
            ps, tpe._default_n_EI_candidates_cat):
        tpe._warn_saturated(
            domain, speculative,
            advice="the adaptive layer pins the categorical candidate count, "
            "so speculation stays off on this space; use plain tpe.suggest "
            "with a lowered n_EI_candidates_cat to re-enable it.",
        )
        speculative = 0

    if speculative and B == 1:
        params = (
            "atpe", float(lock_fraction), int(elite_count), int(n_startup_jobs),
            int(linear_forgetting), id(trials), int(speculative),
            int(speculative) - 1 if max_stale is None else int(max_stale),
            0 if mesh is None else mesh,
        )
        values, active = tpe._speculative_cols(
            domain, trials, seed, int(speculative), max_stale, params, n_startup_jobs,
            lambda s, k: _dense_draw(domain, trials, opt, ensure_rng(s), k,
                                     n_startup_jobs, linear_forgetting, mesh=mesh),
        )
    else:
        values, active = _dense_draw(domain, trials, opt, rng, B, n_startup_jobs,
                                     linear_forgetting, mesh=mesh)

    idxs, vals = dense_to_idxs_vals(new_ids, ps.labels, values, active)
    return docs_from_idxs_vals(new_ids, domain, trials, *tpe._cast_vals(ps, idxs, vals))


# ---------------------------------------------------------------------------
# Program registration (hyperopt-tpu-torch-lint --ir)
# ---------------------------------------------------------------------------

from .ops.compile import ProgramCapture, register_program  # noqa: E402


@register_program(
    "atpe.device_step",
    families=("hyperopt_tpu_torch.atpe:build_atpe_device_fn",),
)
def _registry_atpe_device(p):
    """The adaptive suggest step (settings and locks decided on the card),
    the ``algo='atpe'`` body of ``device_loop.compile_fmin``'s step."""
    return ProgramCapture(
        fn=build_atpe_device_fn(p.space, 25.0),
        args=(p.key_spec(),) + p.history_specs(), kwargs={"batch": p.batch},
    )
