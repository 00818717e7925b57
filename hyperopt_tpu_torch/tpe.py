"""TPE suggest path of the PyTorch port: ``algo=hyperopt_tpu_torch.tpe.suggest``.

The counterpart of :mod:`hyperopt_tpu.tpe_jax`, factorized posterior
only: one ask runs the good/bad split, the adaptive-Parzen fits of every
hyperparameter, the truncated-GMM candidate draws, the EI
log-likelihood-ratio scoring (through the CUDA kernel of
:mod:`hyperopt_tpu_torch.ops.gmm_scores` for unquantized continuous dims)
and the per-dim argmax as tensor ops on the domain's device.  Defaults,
key tree and candidate order are the reference's, so the same seed
suggests the same trials up to float rounding.

Served here: the plain path (one dense draw per ask, prior draws during
startup).  ``joint_ei``, ``speculative``, ``fused``/``resident``
mirrors, ``ask_ahead`` and the fused ``state_io`` program are later work
and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from . import random as R
from .ops import kernels as K
from .rand import docs_from_idxs_vals
from .torch_trials import cached_suggest_fn, obs_buffer_for, packed_space_for
from .vectorize import dense_to_idxs_vals

__all__ = ["suggest", "suggest_batch", "suggest_dense", "build_suggest_fn"]

_default_prior_weight = 1.0
_default_n_EI_candidates = 128
_default_n_EI_candidates_cat = 24
_default_gamma = 0.25
_default_n_startup_jobs = 20
_default_linear_forgetting = 25


def _resolve_above_cap(above_cap):
    """``None`` -> :data:`~hyperopt_tpu_torch.ops.kernels.DEFAULT_ABOVE_CAP`,
    a non-positive value -> None (full-width scoring), an int -> that cap."""
    if above_cap is None:
        return int(K.DEFAULT_ABOVE_CAP)
    cap = int(above_cap)
    return cap if cap > 0 else None


def build_suggest_fn(ps, n_cand, gamma, lf, prior_weight, joint_ei=False,
                     n_cand_cat=None, above_cap=None, state_io=False):
    """The TPE suggest step for a PackedSpace:
    ``fn(key, values, active, losses, valid, batch) -> (new_values [D, B],
    new_active [D, B])``, tensors on the space's device.

    ``n_cand`` candidates per continuous dim, ``n_cand_cat`` (None = same)
    per categorical dim; ``above_cap`` as in :func:`_resolve_above_cap`.
    The key tree is the reference's: ``split(key, B * (Dc + Dk))``, the
    first ``B * Dc`` keys ``[B, Dc]`` for the continuous dims and the next
    ``B * Dk`` ``[B, Dk]`` for the categorical ones.
    """
    if joint_ei or state_io:
        raise NotImplementedError(
            "the port's build_suggest_fn serves the factorized plain path "
            "only; joint_ei and state_io are not ported yet"
        )
    K.check_prior_weight(prior_weight)
    c = ps.consts
    D = ps.n_dims
    Dc = len(ps.cont_idx)
    Dk = len(ps.cat_idx)
    gamma = float(gamma)
    lf_f = float(lf)
    pw = float(prior_weight)
    n_cat = int(n_cand) if n_cand_cat is None else max(1, int(n_cand_cat))
    a_cap = _resolve_above_cap(above_cap)

    def fn(key, values, active, losses, valid, batch):
        fits = K.fit_all_dims(c, values, active, losses, valid, gamma, lf_f,
                              pw, above_cap=a_cap)
        new_values = torch.zeros((D, batch), dtype=torch.float32, device=ps.device)
        keys = R.split(key, max(batch * (Dc + Dk), 1))
        if fits["cont"] is not None:
            cont_keys = keys[: batch * Dc].reshape(batch, Dc, 2)
            cont_vals, _ = K.ei_sweep_cont(ps.q, c, cont_keys, fits["cont"], n_cand)
            new_values[c["cont_idx"]] = cont_vals.T
        if fits["cat"] is not None:
            pb, pa = fits["cat"]
            cat_keys = keys[batch * Dc: batch * (Dc + Dk)].reshape(batch, Dk, 2)
            cat_vals, _ = K.ei_sweep_cat(cat_keys, pb, pa, n_cat)
            new_values[c["cat_idx"]] = cat_vals.T + c["int_low"][:, None]
        return new_values, ps.active_fn(new_values)

    return fn


def _cast_vals(ps, idxs, vals):
    """Dense float draws -> API types (ints for categorical-family dims)."""
    cat_labels = {ps.labels[d] for d in ps.cat_idx}
    for label in vals:
        if label in cat_labels:
            vals[label] = [int(round(v)) for v in vals[label]]
        else:
            vals[label] = [float(v) for v in vals[label]]
    return idxs, vals


def _tpe_builder(ps_, nc, g, lf, pw, ncc, ac):
    return build_suggest_fn(
        ps_, nc, g, lf, pw, n_cand_cat=ncc, above_cap=0 if ac is None else ac,
    )


def suggest_dense(
    domain,
    trials,
    seed,
    batch,
    prior_weight=_default_prior_weight,
    n_startup_jobs=_default_n_startup_jobs,
    n_EI_candidates=_default_n_EI_candidates,
    gamma=_default_gamma,
    linear_forgetting=_default_linear_forgetting,
    n_EI_candidates_cat=_default_n_EI_candidates_cat,
    above_cap=None,
):
    """Dense draws for a batch: (values [D, batch], active [D, batch]) as
    host numpy -- prior draws during startup, TPE after."""
    ps = packed_space_for(domain)
    buf = obs_buffer_for(domain, trials)
    key = R.key(int(seed) % (2**31 - 1), device=ps.device)

    if buf.count < n_startup_jobs:
        buf.dispatch_count += 1
        values, active = ps.sample_prior(key, batch)
    else:
        n_cat = None if n_EI_candidates_cat is None else int(n_EI_candidates_cat)
        a_cap = _resolve_above_cap(above_cap)
        params = (int(n_EI_candidates), float(gamma), float(linear_forgetting),
                  float(prior_weight), n_cat, a_cap)
        fn = cached_suggest_fn(domain, "_tpe_torch_cache", params, _tpe_builder)
        arrays = buf.device_arrays(pow2_cap=a_cap)
        buf.dispatch_count += 1
        values, active = fn(key, *arrays, batch)
    return values.cpu().numpy(), active.cpu().numpy()


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
    n_EI_candidates_cat=_default_n_EI_candidates_cat,
    above_cap=None,
):
    """Sparse (idxs, vals) for a batch of ids -- one suggest step for the
    whole batch (B trials x D dims x n_EI_candidates candidates)."""
    ps = packed_space_for(domain)
    values, active = suggest_dense(
        domain, trials, seed, len(new_ids),
        prior_weight=prior_weight,
        n_startup_jobs=n_startup_jobs,
        n_EI_candidates=n_EI_candidates,
        gamma=gamma,
        linear_forgetting=linear_forgetting,
        n_EI_candidates_cat=n_EI_candidates_cat,
        above_cap=above_cap,
    )
    idxs, vals = dense_to_idxs_vals(new_ids, ps.labels, values, active)
    return _cast_vals(ps, idxs, vals)


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
    joint_ei=False,
    n_EI_candidates_cat=_default_n_EI_candidates_cat,
    speculative=0,
    max_stale=None,
    above_cap=None,
    fused=False,
    resident=None,
    ask_ahead=None,
):
    """The plugin-boundary entry point: ``algo=hyperopt_tpu_torch.tpe.suggest``.

    Takes the reference's arguments; the modes this slice does not serve
    yet (``joint_ei``, ``speculative``, ``max_stale``, ``fused``,
    ``resident``, ``ask_ahead``) raise ``NotImplementedError`` when set.
    """
    unported = [
        name for name, v, off in (
            ("joint_ei", joint_ei, False), ("speculative", speculative, 0),
            ("max_stale", max_stale, None), ("fused", fused, False),
            ("resident", resident, None), ("ask_ahead", ask_ahead, None),
        ) if v != off
    ]
    if unported:
        raise NotImplementedError(
            f"tpe.suggest: {unported} not ported yet; the port serves the "
            "plain factorized path"
        )
    idxs, vals = suggest_batch(
        new_ids, domain, trials, seed,
        prior_weight=prior_weight,
        n_startup_jobs=n_startup_jobs,
        n_EI_candidates=n_EI_candidates,
        gamma=gamma,
        linear_forgetting=linear_forgetting,
        n_EI_candidates_cat=n_EI_candidates_cat,
        above_cap=above_cap,
    )
    return docs_from_idxs_vals(new_ids, domain, trials, idxs, vals)
