"""Annealing on the card: ``algo=hyperopt_tpu_torch.anneal.suggest``.

The counterpart of :mod:`hyperopt_tpu.anneal_jax`: the whole suggest
step -- anchor pick (geometric over the loss rank), per-dimension
shrinking neighborhoods, prior fallbacks for inactive dims, conditional
activity -- as tensor ops over the dense history on the domain's device,
for the whole batch at once.  The key tree is the reference's, and the
multiply-adds that XLA contracts are contracted here too
(:func:`hyperopt_tpu_torch.random._fma`), so the same seed anchors the
same trials.  Annealing scores no candidates, so it launches no kernel
of :mod:`hyperopt_tpu_torch.ops.gmm_scores`.
"""

from __future__ import annotations

import torch

from . import random as R
from .ops.kernels import quantize_nat
from .rand import docs_from_idxs_vals
from .torch_trials import cached_suggest_fn, obs_buffer_for, packed_space_for
from .tpe import _cast_vals, _speculative_cols, _state_dispatch, _to_host, fused_state_io
from .vectorize import dense_to_idxs_vals

__all__ = ["suggest", "suggest_batch", "build_anneal_fn"]

_default_avg_best_idx = 2.0
_default_shrink_coef = 0.1


def build_anneal_fn(ps, avg_best_idx, shrink_coef, state_io=False):
    """The annealing suggest step for a PackedSpace: ``fn(key, values,
    active, losses, valid, batch) -> (new_values [D, B], new_active [D,
    B])``; ``state_io=True`` returns the fused tell+ask form
    (:func:`hyperopt_tpu_torch.tpe.fused_state_io`).  Semantics of
    :class:`hyperopt_tpu.anneal.AnnealingAlgo`:

    * anchor trial per suggestion: rank ``geometric(1/avg_best_idx) - 1``
      into the loss-sorted ok history (clamped);
    * continuous dims: bounded dims draw uniform on the anchor-centred
      interval of latent width ``(high-low) * frac``, clipped to the
      bounds; unbounded dims draw ``normal(anchor, sigma * frac)``;
      ``frac = 1 / (1 + n_obs_d * shrink_coef)`` with per-dim obs counts;
    * categorical dims: redraw from the prior with probability ``frac``,
      else keep the anchor's category;
    * a dim inactive on the anchor, or an empty history, draws the prior.

    Keys ``[N, 2]`` with a state of the same leading axis anneal N
    studies at once (the study-batched engine's body), study ``i``'s
    slice bitwise a solo call on its own state.
    """
    c = ps.consts
    D = ps.n_dims
    Dc = len(ps.cont_idx)
    Dk = len(ps.cat_idx)
    sc = float(shrink_coef)
    p = 1.0 / max(float(avg_best_idx), 1.0 + 1e-9)
    # log1p(-p) in float32 as XLA evaluates it (the rank's denominator)
    log1m_p = R._log1p(torch.tensor(-p, dtype=torch.float32, device=ps.device))
    sc_t = torch.tensor(sc, dtype=torch.float32, device=ps.device)

    def fn(key, values, active, losses, valid, batch):
        kr, ku, kz, kcoin, kp = R.split(key, 5).unbind(-2)
        dev = values.device
        lead = key.shape[:-1]  # () for one study, (N,) for a stack

        ok = valid & torch.isfinite(losses)
        n_ok = torch.sum(ok.to(torch.int64), dim=-1)
        order = torch.argsort(torch.where(ok, losses, torch.inf), dim=-1, stable=True)

        # geometric(p) - 1 ranks by inverse transform
        u = R.uniform(kr, (batch,), 1e-12, 1.0)
        rank = torch.floor(R._log(u) / log1m_p).to(torch.int64)
        rank = torch.minimum(torch.clamp(rank, min=0), torch.clamp(n_ok - 1, min=0)[..., None])
        cols = torch.gather(order, -1, rank)  # [..., B] anchor slots

        at = cols[..., None, :].expand(lead + (D, batch))
        anchor_vals = torch.gather(values, -1, at)  # [..., D, B]
        anchor_act = torch.gather(active, -1, at) & (n_ok > 0)[..., None, None]

        # per-dim observation counts -> neighborhood shrink fraction
        n_obs = torch.sum((active & ok[..., None, :]).to(torch.float32), dim=-1)
        frac = 1.0 / R._fma(n_obs, sc_t, 1.0)

        prior_vals, _ = ps.sample_prior_fn(kp, batch)
        new_values = torch.zeros(lead + (D, batch), dtype=torch.float32, device=dev)

        if Dc:
            ci = c["cont_idx"]
            a_nat = anchor_vals[..., ci, :]
            logspace = c["logspace"][:, None]
            lat_a = torch.where(logspace, torch.log(torch.clamp(a_nat, min=1e-30)), a_nat)
            low, high = c["low"][:, None], c["high"][:, None]
            fr = frac[..., ci][..., None]
            bounded = torch.isfinite(low)

            uu = R.uniform(ku, (Dc, batch))
            zz = R.normal(kz, (Dc, batch))

            width = (high - low) * fr
            lo2 = torch.maximum(low, lat_a - width / 2.0)
            hi2 = torch.minimum(high, lat_a + width / 2.0)
            lat_b = R._fma(uu, torch.clamp(hi2 - lo2, min=0.0), lo2)
            lat_u = R._fma(c["prior_sigma"][:, None] * fr, zz, lat_a)
            lat = torch.where(bounded, lat_b, lat_u)

            nat = torch.where(logspace, torch.exp(lat), lat)
            nat = quantize_nat(nat, c["q"][:, None], low, high, logspace)
            new_values[..., ci, :] = torch.where(anchor_act[..., ci, :], nat,
                                                 prior_vals[..., ci, :])

        if Dk:
            ki = c["cat_idx"]
            coin = R.uniform(kcoin, (Dk, batch))
            redraw = coin < frac[..., ki][..., None]
            new_values[..., ki, :] = torch.where(redraw | ~anchor_act[..., ki, :],
                                                 prior_vals[..., ki, :], anchor_vals[..., ki, :])

        return new_values, ps.active_fn(new_values)

    return fused_state_io(fn) if state_io else fn


def _anneal_builder(ps_, abi, sc, sio):
    return build_anneal_fn(ps_, abi, sc, state_io=sio)


def _dense_draw(domain, trials, seed, batch, avg_best_idx, shrink_coef):
    """One draw of ``batch`` suggestions as host numpy: the prior on an
    empty history, else annealing through the shared state engine
    (:func:`hyperopt_tpu_torch.tpe._state_dispatch`)."""
    ps = packed_space_for(domain)
    buf = obs_buffer_for(domain, trials)
    key = R.key(int(seed) % (2**31 - 1), device=ps.device)

    if buf.count == 0:
        buf.dispatch_count += 1
        return _to_host(*ps.sample_prior(key, batch))
    params = (float(avg_best_idx), float(shrink_coef))
    fn = cached_suggest_fn(domain, "_anneal_torch_cache", params + (False,), _anneal_builder)
    fused = (cached_suggest_fn(domain, "_anneal_torch_cache", params + (True,), _anneal_builder)
             if buf.resident else None)
    return _to_host(*_state_dispatch(buf, key, batch, None, fn, fused))


def suggest_batch(new_ids, domain, trials, seed, avg_best_idx=_default_avg_best_idx,
                  shrink_coef=_default_shrink_coef):
    """Sparse (idxs, vals) for a batch of ids -- one annealing step."""
    ps = packed_space_for(domain)
    values, active = _dense_draw(domain, trials, seed, len(new_ids), avg_best_idx, shrink_coef)
    return _cast_vals(ps, *dense_to_idxs_vals(new_ids, ps.labels, values, active))


def suggest(
    new_ids,
    domain,
    trials,
    seed,
    avg_best_idx=_default_avg_best_idx,
    shrink_coef=_default_shrink_coef,
    speculative=0,
    max_stale=None,
    resident=None,
):
    """The plugin-boundary entry point: ``algo=hyperopt_tpu_torch.anneal.suggest``.

    ``speculative=k`` serves k sequential asks from one k-wide draw (the
    cache/staleness semantics of :func:`hyperopt_tpu_torch.tpe.suggest`).
    ``resident=True`` keeps the history on the device: tells become O(D)
    deltas, fused into the ask when exactly one is pending; the stream
    is bitwise the re-upload one.
    """
    ps = packed_space_for(domain)
    if resident is not None:
        obs_buffer_for(domain, trials, resident=bool(resident))
    if speculative and len(new_ids) == 1:
        params = (
            "anneal", float(avg_best_idx), float(shrink_coef),
            id(trials), int(speculative),
            int(speculative) - 1 if max_stale is None else int(max_stale),
        )
        values, active = _speculative_cols(
            domain, trials, seed, int(speculative), max_stale, params,
            1,  # 'warm' flips once any history exists (prior -> anneal)
            lambda s, k: _dense_draw(domain, trials, s, k, avg_best_idx, shrink_coef),
        )
        idxs, vals = _cast_vals(ps, *dense_to_idxs_vals(new_ids, ps.labels, values, active))
    else:
        idxs, vals = suggest_batch(new_ids, domain, trials, seed,
                                   avg_best_idx=avg_best_idx, shrink_coef=shrink_coef)
    return docs_from_idxs_vals(new_ids, domain, trials, idxs, vals)


# ---------------------------------------------------------------------------
# Program registrations (hyperopt-tpu-torch-lint --ir)
# ---------------------------------------------------------------------------

from .ops.compile import ProgramCapture, register_program  # noqa: E402

_ANNEAL_FAMILIES = ("hyperopt_tpu_torch.anneal:build_anneal_fn",
                    "hyperopt_tpu_torch.tpe:fused_state_io")


@register_program("anneal.suggest", families=_ANNEAL_FAMILIES)
def _registry_anneal_suggest(p):
    return ProgramCapture(
        fn=build_anneal_fn(p.space, _default_avg_best_idx, _default_shrink_coef),
        args=(p.key_spec(),) + p.history_specs(), kwargs={"batch": p.batch},
    )


@register_program("anneal.fused_tell_ask", families=_ANNEAL_FAMILIES)
def _registry_anneal_fused(p):
    """The annealing twin of ``tpe.fused_tell_ask`` (the same in-place
    state contract, the shared ``_state_dispatch`` driver)."""
    return ProgramCapture(
        fn=build_anneal_fn(p.space, _default_avg_best_idx, _default_shrink_coef,
                           state_io=True),
        args=(p.key_spec(),) + p.history_specs(),
        kwargs={**p.delta_specs(), "batch": 1}, mutates=(1, 2, 3, 4),
        # the suggest closure of anneal.suggest behind the delta write of
        # torch_trials.apply_delta: both pin their GL402 behavior
        x64_check=False,
    )
