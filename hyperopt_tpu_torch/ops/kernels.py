"""TPE math of the PyTorch port, as batched tensor ops.

The counterpart of :mod:`hyperopt_tpu.ops.kernels`: the O(D) delta tells
of the resident history, the fits, the draws and the EI sweeps of the
factorized and the joint suggest paths.  Names and argument order are
the reference's; where the
reference maps a per-dimension function with ``vmap``, the port's
function takes explicit leading batch dimensions instead (``[..., N]``
buffers with one row per dimension, ``[...]`` per-row scalars).

* observations live in fixed-capacity buffers with validity masks;
* truncated sampling is inverse-CDF (``ndtri``), never rejection loops;
* sorts are stable (``torch.sort(stable=True)``), so tie order -- and
  with it every mask and index -- matches the reference's exactly;
* the component pick of the sampler is a gather, which is exact where
  the reference contracts a one-hot against the parameters;
* on the card, the float sums and scans along a history or component
  axis add in a fixed order (:func:`sum_rows`, :func:`cumsum_rows`), so
  a study's slice of a stacked state carries the bits of the same study
  alone; PyTorch's own CUDA reductions pick their order from the whole
  tensor's shape.

Floats agree with the reference to a few ulp, not bit for bit: XLA
contracts multiply-adds into FMAs and its ``exp``/``log``/``ndtr``/
``ndtri`` differ from PyTorch's in the last bits.  The continuous EI
scoring of unquantized dims runs through the hand-written CUDA kernel of
:mod:`hyperopt_tpu_torch.ops.gmm_scores` on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.special import ndtr, ndtri

from .. import random as R
from .gmm_scores import gmm_llr, gmm_llr_stacked, gmm_logpdf_cont_pre

__all__ = [
    "DEFAULT_ABOVE_CAP",
    "HistoryState",
    "apply_delta",
    "apply_delta_masked",
    "apply_delta_stacked",
    "categorical_fit",
    "check_prior_weight",
    "compact_below",
    "compact_gmm",
    "ei_best_cat",
    "ei_scores_cat",
    "ei_sweep_cat",
    "ei_sweep_cat_scores",
    "ei_sweep_cont",
    "ei_sweep_cont_candidates",
    "ei_sweep_cont_scores",
    "fit_all_dims",
    "forgetting_weights",
    "gmm_logpdf_cont_pre",
    "gmm_logpdf_quant_pre",
    "gmm_precompute",
    "history_summary",
    "ladder_cumsum",
    "parzen_fit",
    "quantize_nat",
    "split_below_above",
    "cumsum_rows",
    "sum_rows",
    "tree_sum",
    "trunc_gmm_sample_pre",
]

TINY = 1e-12
F32_TINY = 1e-30
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)

# Default component cap for the ABOVE Parzen model (the reference's
# DEFAULT_ABOVE_CAP): below it the compaction is the identity.
DEFAULT_ABOVE_CAP = 512


class HistoryState(NamedTuple):
    """The four dense observation tensors every suggest path threads."""

    values: torch.Tensor  # [D, cap] natural-space draws
    active: torch.Tensor  # [D, cap] per-dim activity mask
    losses: torch.Tensor  # [cap]
    valid: torch.Tensor  # [cap] slot occupancy


def history_summary(state, best_of=None):
    """(best finite loss, occupied slots) of a :class:`HistoryState`, as
    tensors over its leading dims: the chunk-boundary progress row of
    the compiled loop (:func:`hyperopt_tpu_torch.device_loop.compile_fmin`
    with ``chunk_size``).  ``best`` is ``inf`` while no finite loss
    exists; a bool mask ``best_of`` (the slots of full-fidelity trials
    under ``asha=``) narrows the slots it is taken over."""
    ok = state.valid & torch.isfinite(state.losses)
    if best_of is not None:
        ok = ok & best_of
    best = torch.amin(torch.where(ok, state.losses, torch.inf), dim=-1)
    done = torch.sum(state.valid.to(torch.int64), dim=-1)
    return best, done


def tree_sum(x, dim=-1, keepdim=False):
    """Sum along ``dim`` by a fixed pairwise tree of elementwise adds: the
    axis is zero-padded to a power of two and halved (``x[:h] + x[h:]``)
    until one element is left.  Every add is elementwise, so a row's bits
    depend on its own length only, never on the rows beside it."""
    dim = dim % x.dim()
    n = x.shape[dim]
    width = 1 << (max(n, 1) - 1).bit_length()
    if width > n:
        pad = list(x.shape)
        pad[dim] = width - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while width > 1:
        width //= 2
        x = x.narrow(dim, 0, width) + x.narrow(dim, width, width)
    return x if keepdim else x.squeeze(dim)


def ladder_cumsum(x, dim=-1):
    """Inclusive prefix sum along ``dim`` by a Hillis-Steele ladder of
    elementwise adds (step ``d`` adds the element ``d`` places back, ``d
    = 1, 2, 4, ...``): like :func:`tree_sum`, a row's bits depend on its
    own length only."""
    dim = dim % x.dim()
    n = x.shape[dim]
    d = 1
    while d < n:
        x = torch.cat([x.narrow(dim, 0, d), x.narrow(dim, d, n - d) + x.narrow(dim, 0, n - d)],
                      dim=dim)
        d *= 2
    return x


def sum_rows(x, dim=-1, keepdim=False):
    """``torch.sum`` on CPU tensors (whose order is already per row);
    :func:`tree_sum` on the card."""
    if x.device.type == "cpu":
        return torch.sum(x, dim=dim, keepdim=keepdim)
    return tree_sum(x, dim=dim, keepdim=keepdim)


def cumsum_rows(x, dim=-1):
    """``torch.cumsum`` on CPU tensors; :func:`ladder_cumsum` on the card."""
    if x.device.type == "cpu":
        return torch.cumsum(x, dim=dim)
    return ladder_cumsum(x, dim=dim)


def _on(x, like):
    """A delta's host column (numpy or tensor) as ``like``'s dtype and device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def apply_delta(values, active, losses, valid, vcol, acol, loss, idx):
    """Stage one completed trial into the history: an O(D) delta tell.

    Writes the value/active column ``vcol``/``acol`` ``[D]`` and the loss
    into slot ``idx`` and marks the slot occupied, IN PLACE on the four
    tensors (the reference donates them to an XLA update instead); returns
    them as a :class:`HistoryState`.  ``idx`` is a host int (no device
    sync) or an index tensor.  The write is pure data movement, so the
    state is bitwise what a fresh upload of the same host arrays gives.
    Only in-order appends come through here: ``valid`` is a prefix mask.
    """
    values[:, idx] = _on(vcol, values)
    active[:, idx] = _on(acol, active)
    losses[idx] = loss if torch.is_tensor(loss) else float(loss)  # a fill, no copy
    valid[idx] = True
    return HistoryState(values, active, losses, valid)


def apply_delta_masked(values, active, losses, valid, vcol, acol, loss,
                       idx, apply):
    """:func:`apply_delta` gated by a device flag ``apply`` (bool, 0-dim):
    where it is true the slot takes the delta, where false it keeps its
    bits -- one launch sequence for every tell/no-tell mix, no sync."""
    apply = torch.as_tensor(apply, dtype=torch.bool, device=values.device)
    values[:, idx] = torch.where(apply, _on(vcol, values), values[:, idx])
    active[:, idx] = torch.where(apply, _on(acol, active), active[:, idx])
    losses[idx] = torch.where(apply, _on(loss, losses), losses[idx])
    valid[idx] = valid[idx] | apply
    return HistoryState(values, active, losses, valid)


def apply_delta_stacked(values, active, losses, valid, vcol, acol, loss, idx, apply):
    """:func:`apply_delta_masked` for N stacked studies in one launch
    sequence: slot ``i`` takes its column ``vcol[i]``/``acol[i]`` ``[N,
    D]`` and ``loss[i]`` at its own index ``idx[i]`` where ``apply[i]``
    is set, and keeps its bits elsewhere (``idx`` ``[N]`` int, ``apply``
    ``[N]`` bool; host arrays or tensors).  One gather and one scatter
    per state tensor, IN PLACE; returns the four as a
    :class:`HistoryState`.  Slot ``i`` of the result is bitwise
    :func:`apply_delta` on study ``i`` where ``apply[i]`` holds."""
    dev = values.device
    slots = torch.arange(values.shape[0], device=dev)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    apply = torch.as_tensor(apply, dtype=torch.bool, device=dev)
    col = apply[:, None]
    values[slots, :, idx] = torch.where(col, _on(vcol, values), values[slots, :, idx])
    active[slots, :, idx] = torch.where(col, _on(acol, active), active[slots, :, idx])
    losses[slots, idx] = torch.where(apply, _on(loss, losses), losses[slots, idx])
    valid[slots, idx] = valid[slots, idx] | apply
    return HistoryState(values, active, losses, valid)


def _per_row(x, n, device):
    """A per-step scalar as an ``[..., n]`` float32 vector: a Python
    number fills, a tensor (a traced adaptive setting on the program's
    device, one per study of a leading axis) is expanded as is, so no
    device->host sync and no transfer is made."""
    if torch.is_tensor(x):
        x = x.to(torch.float32)
        return x[..., None].expand(x.shape + (n,))
    return torch.full((n,), x, dtype=torch.float32, device=device)


def check_prior_weight(prior_weight):
    """Builder guard: a zero-weight prior with an empty below set would
    sample from zeroed component params."""
    if prior_weight <= 0:
        raise ValueError(
            "prior_weight must be > 0: a zero-weight prior degenerates "
            "the below-model mixture for dims with no observations"
        )


def _below_pad(lf, cap=None, gamma=None):
    """Static buffer width for the compacted below set:
    ``min(lf, ceil(gamma * sqrt(cap)) + 1)`` rounded up to a multiple of
    8 (the +1 absorbs float32-vs-float64 ceil disagreement)."""
    bound = int(lf)
    if cap is not None and gamma is not None and gamma > 0:
        bound = min(bound, int(math.ceil(gamma * math.sqrt(float(cap)))) + 1)
    return max(8, (bound + 7) // 8 * 8)


def _above_pad(above_cap):
    """Static padded width of the compacted above model."""
    return max(8, (int(above_cap) + 7) // 8 * 8)


def _col(x):
    """A per-row scalar as a ``[..., 1]`` column (Python numbers pass)."""
    return x[..., None] if torch.is_tensor(x) else x


def _safe_log(x):
    return torch.log(torch.clamp(x, min=F32_TINY))


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` with tensor bounds."""
    return torch.minimum(torch.maximum(x, lo), hi)


def forgetting_weights(mask, lf):
    """Linear-forgetting weights over masked, slot-time-ordered rows
    ``[..., N]``: the newest ``lf`` valid observations weigh 1, older ones
    ramp linearly from 1/n; zeros elsewhere."""
    mask_f = mask.to(torch.float32)
    n = torch.sum(mask_f, dim=-1, keepdim=True)
    rank = torch.cumsum(mask_f, dim=-1) - 1.0
    n_ramp = torch.clamp(n - _col(lf), min=0.0)
    inv_n = 1.0 / torch.clamp(n, min=1.0)
    ramp = inv_n + rank * (1.0 - inv_n) / torch.clamp(n_ramp - 1.0, min=1.0)
    w = torch.where(rank >= n_ramp, 1.0, ramp)
    return w * mask_f


def parzen_fit(obs, mask, prior_mu, prior_sigma, prior_weight, lf):
    """Adaptive-Parzen GMM fit over masked observation rows.

    Args:
      obs: [..., N] observed values (latent space; garbage where masked).
      mask: [..., N] bool validity.
      prior_mu, prior_sigma, prior_weight, lf: [...] per-row scalars.

    Returns (weights, mus, sigmas), each [..., N + 1]: one component per
    slot plus the prior, sorted by mu (stable: the prior sorts after an
    equal observation); invalid slots carry weight 0, mu 0, sigma 1.
    """
    n = torch.sum(mask.to(torch.float32), dim=-1)
    tw = forgetting_weights(mask, lf)

    ones = torch.ones(mask.shape[:-1] + (1,), dtype=torch.bool, device=mask.device)
    vals = torch.cat([torch.where(mask, obs, torch.inf), prior_mu[..., None]], dim=-1)
    wts = torch.cat([tw, prior_weight[..., None]], dim=-1)
    valid = torch.cat([mask, ones], dim=-1)
    is_prior = torch.cat([torch.zeros_like(mask), ones], dim=-1)

    sv, order = torch.sort(vals, dim=-1, stable=True)
    sw = torch.gather(wts, -1, order)
    sprior = torch.gather(is_prior, -1, order)
    svalid = torch.gather(valid, -1, order)

    pad_f = torch.full(sv.shape[:-1] + (1,), -torch.inf, dtype=sv.dtype, device=sv.device)
    pad_b = torch.zeros(sv.shape[:-1] + (1,), dtype=torch.bool, device=sv.device)
    gap = sv[..., 1:] - sv[..., :-1]
    left_gap = torch.cat([pad_f, gap], dim=-1)
    right_gap = torch.cat([gap, pad_f], dim=-1)
    left_avail = torch.cat([pad_b, svalid[..., :-1]], dim=-1)
    right_avail = torch.cat([svalid[..., 1:], pad_b], dim=-1)
    raw = torch.maximum(
        torch.where(left_avail, left_gap, -torch.inf),
        torch.where(right_avail, right_gap, -torch.inf),
    )
    psig = prior_sigma[..., None]
    raw = torch.where(torch.isfinite(raw), raw, psig)

    minsigma = psig / torch.clamp(1.0 + n[..., None], max=100.0)
    sigma = _clip(raw, minsigma, psig)
    sigma = torch.where(sprior, psig, sigma)
    sigma = torch.where(svalid, sigma, 1.0)

    sw = torch.where(svalid, sw, 0.0)
    sw = sw / torch.clamp(sum_rows(sw, dim=-1, keepdim=True), min=F32_TINY)
    sv = torch.where(svalid, sv, 0.0)  # keep padded mus finite downstream
    return sw, sv, sigma


def compact_below(obs_row, below_row, lf_pad):
    """Gather the first ``lf_pad`` below-set slots of each row (in slot
    order) into a small buffer -- the reference's ``top_k`` over
    descending slot keys, as a stable descending sort so equal keys keep
    the lower index first, as ``top_k`` does."""
    n = below_row.shape[-1]
    ramp = torch.arange(n, 0, -1, dtype=torch.int64, device=below_row.device)
    slot_key = torch.where(below_row, ramp, 0)
    _, idx = torch.sort(slot_key, dim=-1, descending=True, stable=True)
    idx = idx[..., :lf_pad]
    return torch.gather(obs_row, -1, idx), torch.gather(below_row, -1, idx)


def compact_gmm(weights, mus, sigmas, out_width):
    """Merge sorted Parzen mixtures ``[..., K]`` (live components a
    prefix) into ``out_width`` components by moment-matching contiguous
    runs of near-equal size; a run holding one live component passes it
    through untouched, so while the live count fits the grouping is the
    identity (see :func:`hyperopt_tpu.ops.kernels.compact_gmm`)."""
    k = weights.shape[-1]
    dev = weights.device
    live = weights > 0
    n_live = torch.sum(live.to(torch.int64), dim=-1, keepdim=True)
    scale = torch.clamp(n_live, min=out_width)
    g = torch.arange(out_width + 1, dtype=torch.int64, device=dev)
    bounds = torch.clamp((g * scale + out_width - 1) // out_width, 0, k)

    sig2 = sigmas * sigmas
    cols = torch.stack(
        [weights, weights * mus, weights * mus * mus, weights * sig2,
         live.to(weights.dtype)],
        dim=-1,
    )  # [..., K, 5]
    zero = torch.zeros(cols.shape[:-2] + (1, 5), dtype=cols.dtype, device=dev)
    p = torch.cat([zero, cumsum_rows(cols, dim=-2)], dim=-2)  # [..., K+1, 5]

    def rows(t, idx):
        return torch.gather(t, -2, idx[..., None].expand(idx.shape + (t.shape[-1],)))

    seg = rows(p, bounds[..., 1:]) - rows(p, bounds[..., :-1])  # [..., W, 5]
    w_g = seg[..., 0]
    cnt = seg[..., 4]
    live_g = cnt > 0
    single = cnt == 1.0
    w_safe = torch.clamp(w_g, min=F32_TINY)
    mu_g = seg[..., 1] / w_safe
    spread = torch.clamp(seg[..., 2] / w_safe - mu_g * mu_g, min=0.0)
    sigma_g = torch.sqrt(seg[..., 3] / w_safe + spread)

    orig = rows(
        torch.stack([weights, mus, sigmas], dim=-1),
        torch.clamp(bounds[..., :-1], 0, k - 1),
    )  # [..., W, 3]
    w_out = torch.where(single, orig[..., 0], torch.where(live_g, w_g, 0.0))
    mu_out = torch.where(single, orig[..., 1], torch.where(live_g, mu_g, 0.0))
    s_out = torch.where(single, orig[..., 2], torch.where(live_g, sigma_g, 1.0))
    return w_out, mu_out, s_out


def split_below_above(losses, valid, gamma, lf):
    """Good/bad split over masked loss rows ``[..., cap]``: ``n_below =
    min(ceil(gamma * sqrt(n_ok)), lf)`` per row, ties broken by slot
    order (a stable argsort).  Returns (below_mask, above_mask, n_below
    ``[...]``)."""
    valid = valid & torch.isfinite(losses)
    n_ok = torch.sum(valid.to(torch.float32), dim=-1)
    n_below = torch.clamp(torch.ceil(gamma * torch.sqrt(n_ok)), max=lf)

    keyed = torch.where(valid, losses, torch.inf)
    order = torch.argsort(keyed, dim=-1, stable=True)
    ramp = torch.arange(order.shape[-1], dtype=order.dtype, device=order.device)
    rank = torch.empty_like(order).scatter_(-1, order, ramp.expand_as(order))
    below = valid & (rank < n_below[..., None])
    above = valid & ~below
    return below, above, n_below


def categorical_fit(obs, mask, prior_p, prior_weight, lf):
    """Categorical posteriors ``[..., K]`` from forgetting-weighted counts
    over rows ``[..., N]`` of category indices plus prior pseudocounts."""
    tw = forgetting_weights(mask, lf)
    k = prior_p.shape[-1]
    cats = torch.arange(k, dtype=obs.dtype, device=obs.device)
    onehot = (obs[..., :, None] == cats).to(tw.dtype)  # [..., N, K]
    counts = sum_rows(onehot * tw[..., None], dim=-2)
    has = prior_p > 0
    n_options = torch.sum(has, dim=-1, keepdim=True).to(counts.dtype)
    pseudo = counts * has + _col(prior_weight) * prior_p * n_options
    return pseudo / torch.clamp(sum_rows(pseudo, dim=-1, keepdim=True), min=F32_TINY)


def fit_all_dims(ps_consts, values, active, losses, valid, gamma, lf,
                 prior_weight, pad_gamma=None, above_cap=None):
    """Good/bad split + Parzen/categorical fits for every dimension.

    ``ps_consts`` is :attr:`PackedSpace.consts`.  Returns a dict with the
    continuous fits ``(wb, mb, sb, wa, ma, sa)`` (below compacted to
    ``[Dc, lf_pad + 1]``, above ``[Dc, cap + 1]`` or compacted to the
    above cap) and the categorical posteriors ``(pb, pa)`` ``[Dk, k_max]``;
    entries are None for absent families.  A history with leading study
    dims (``values [..., D, cap]``, ``losses [..., cap]``) fits every
    study at once: each output gains the same leading dims.
    """
    below, above, _ = split_below_above(losses, valid, gamma, lf)
    out = {"cont": None, "cat": None}
    lf_pad = _below_pad(
        lf, cap=losses.shape[-1],
        gamma=gamma if pad_gamma is None else pad_gamma,
    )
    dev = values.device
    lead = values.shape[:-2]

    def rows(*per_dim):
        # per-dimension settings spread over the leading study dims (a
        # per-study setting already carries them)
        return [t.expand(lead + t.shape[-1:]) for t in per_dim] if lead else list(per_dim)

    cont_idx = ps_consts["cont_idx"]
    dc = cont_idx.shape[0]
    if dc:
        obs_c = values[..., cont_idx, :]
        lat = torch.where(ps_consts["logspace"][:, None], _safe_log(obs_c), obs_c)
        act_c = active[..., cont_idx, :]
        pw_v, lf_v, mu, sigma = rows(
            _per_row(prior_weight, dc, dev),
            torch.full((dc,), lf, dtype=torch.float32, device=dev),
            ps_consts["prior_mu"], ps_consts["prior_sigma"],
        )
        lat_b, mask_b = compact_below(lat, act_c & below[..., None, :], lf_pad)
        wb, mb, sb = parzen_fit(lat_b, mask_b, mu, sigma, pw_v, lf_v)
        wa, ma, sa = parzen_fit(lat, act_c & above[..., None, :], mu, sigma, pw_v, lf_v)
        if above_cap is not None:
            a_pad = _above_pad(above_cap)
            if wa.shape[-1] > a_pad:
                wa, ma, sa = compact_gmm(wa, ma, sa, a_pad)
        out["cont"] = (wb, mb, sb, wa, ma, sa)

    cat_idx = ps_consts["cat_idx"]
    dk = cat_idx.shape[0]
    if dk:
        obs_k = values[..., cat_idx, :] - ps_consts["int_low"][:, None]
        act_k = active[..., cat_idx, :]
        pw_v, lf_v = rows(
            _per_row(prior_weight, dk, dev),
            torch.full((dk,), lf, dtype=torch.float32, device=dev),
        )
        obs_kb, mask_kb = compact_below(obs_k, act_k & below[..., None, :], lf_pad)
        pb = categorical_fit(obs_kb, mask_kb, ps_consts["prior_p"], pw_v, lf_v)
        pa = categorical_fit(
            obs_k, act_k & above[..., None, :], ps_consts["prior_p"], pw_v, lf_v
        )
        out["cat"] = (pb, pa)

    return out


def quantize_nat(nat, q, low, high, logspace):
    """Natural-space quantization: round to the q-grid and clip to the
    rounded finite bounds; ``low``/``high`` are latent (log-space dims
    exponentiate).  ``q <= 0`` passes through.  Arguments broadcast."""
    qq = torch.clamp(q, min=TINY)
    nat_low = torch.where(logspace, torch.exp(low), low)
    nat_high = torch.where(logspace, torch.exp(high), high)
    rounded = torch.round(nat / qq) * qq
    rounded = _clip(
        rounded,
        torch.where(torch.isfinite(nat_low), torch.round(nat_low / qq) * qq, nat_low),
        torch.where(torch.isfinite(nat_high), torch.round(nat_high / qq) * qq, nat_high),
    )
    return torch.where(q > 0, rounded, nat)


def gmm_precompute(weights, mus, sigmas, low, high):
    """Per-component constants ``[..., K]`` shared by sampling and
    scoring, for mixtures ``[..., K]`` truncated to per-row latent bounds
    ``low``/``high`` ``[...]``.  ``c1`` folds every additive term of the
    truncated-normal log-density (a scored term is ``c1 - 0.5 z^2``);
    ``c1max`` ``[...]`` bounds every term from above."""
    lo, hi = low[..., None], high[..., None]
    sig = torch.clamp(sigmas, min=TINY)
    inv_s = 1.0 / sig
    a = ndtr((lo - mus) * inv_s)
    b = ndtr((hi - mus) * inv_s)
    log_mass = _safe_log(b - a)
    pos = weights > 0
    logw = torch.where(pos, _safe_log(weights), -torch.inf)
    c1 = torch.where(pos, logw - log_mass - torch.log(sig) - _LOG_SQRT_2PI, -torch.inf)
    c1max = torch.amax(c1, dim=-1)
    c1max = torch.where(torch.isfinite(c1max), c1max, 0.0)
    cdf = cumsum_rows(torch.clamp(weights, min=0.0), dim=-1)
    cdf_lo = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]], dim=-1)
    return {
        "mus": mus,
        "inv_s": inv_s,
        "mu_inv_s": mus * inv_s,
        "wmass": torch.where(pos, weights / torch.clamp(b - a, min=TINY), 0.0),
        "c1": c1,
        "c1max": c1max,
        "cdf": cdf,
        "cdf_lo": cdf_lo,
        "params4": torch.stack([mus, sig, a, b], dim=-1),
    }


def _inverse_cdf_onehot(u, cdf, cdf_lo=None):
    """[..., S, K] one-hot component pick per sample ``u [..., S]`` by
    inverse CDF on the weight cumsum ``cdf [..., K]``: component k is
    picked iff ``cdf[k-1] <= scaled < cdf[k]``, with ``scaled`` clamped
    strictly below ``cdf[-1]``; zero-weight slots are empty intervals."""
    if cdf_lo is None:
        cdf_lo = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]], dim=-1)
    total = cdf[..., -1:]
    scaled = torch.minimum(u * total, total * (1.0 - 1e-6))[..., None]
    return ((scaled >= cdf_lo[..., None, :]) & (scaled < cdf[..., None, :])).to(u.dtype)


def trunc_gmm_sample_pre(key, pre, low, high, logspace, q, n_samples):
    """Draw ``n_samples`` per key from truncated (latent-space) GMMs given
    their :func:`gmm_precompute` dict.  ``key [..., 2]``; ``pre`` entries
    ``[..., K]`` and ``low/high/logspace/q [...]`` broadcast against the
    key batch.  Returns natural-space draws ``[..., n_samples]``.

    Per key: ``split(key)`` into the component and the truncation keys,
    one uniform each per sample; inverse-CDF truncation, no rejection.
    """
    ks = R.split(key, 2)
    u_comp = R.uniform(ks[..., 0, :], (n_samples,))
    onehot = _inverse_cdf_onehot(u_comp, pre["cdf"], pre["cdf_lo"])
    comp = torch.argmax(onehot, dim=-1)  # exactly one hit per sample
    params4 = pre["params4"].expand(comp.shape[:-1] + pre["params4"].shape[-2:])
    picked = torch.gather(params4, -2, comp[..., None].expand(comp.shape + (4,)))
    m, s, a, b = picked.unbind(-1)

    u = R.uniform(ks[..., 1, :], (n_samples,))
    p = torch.clamp(a + u * (b - a), TINY, 1.0 - 1e-7)
    x = m + s * ndtri(p)
    lo, hi, ls = low[..., None], high[..., None], logspace[..., None]
    x = _clip(x, lo, hi)
    nat = torch.where(ls, torch.exp(x), x)
    return quantize_nat(nat, q[..., None], lo, hi, ls)


def gmm_logpdf_quant_pre(x, pre, low, high, logspace, q):
    """Quantized bin-mass log-density at natural-space ``x [..., S]``
    under mixtures ``pre [..., K]`` with per-row ``low/high/logspace/q
    [...]``: a direct weighted sum of bin masses, one log at the end
    (a zero-mass bin scores ~log(1e-38))."""
    qq = torch.clamp(q, min=TINY)[..., None]
    ls = logspace[..., None]
    ub_nat = x + qq / 2.0
    lb_nat = x - qq / 2.0
    ub_lat = torch.where(ls, _safe_log(ub_nat), ub_nat)[..., None]
    lb_lat = torch.where(ls, _safe_log(lb_nat), lb_nat)[..., None]
    ub_lat = torch.minimum(ub_lat, high[..., None, None])
    lb_lat = torch.maximum(lb_lat, low[..., None, None])
    inv_s = pre["inv_s"][..., None, :]
    mu_inv_s = pre["mu_inv_s"][..., None, :]
    bin_mass = ndtr(ub_lat * inv_s - mu_inv_s) - ndtr(lb_lat * inv_s - mu_inv_s)
    p = sum_rows(pre["wmass"][..., None, :] * bin_mass, dim=-1)
    return torch.log(torch.clamp(p, min=1e-38))


def ei_best_cat(key, p_below, p_above, n_cand):
    """Categorical dims: draw ``n_cand`` categories per key from the below
    posteriors, score ``log p_b - log p_a``, return (best index as float,
    best score), each ``[...]`` for ``key [..., 2]`` and posteriors
    ``[..., K]``.  The winner is the highest-llr category hit by any draw.
    """
    u = R.uniform(key, (n_cand,))
    onehot = _inverse_cdf_onehot(u, cumsum_rows(torch.clamp(p_below, min=0.0), dim=-1))
    hit = torch.sum(onehot, dim=-2) > 0  # [..., K]
    llr = torch.where(
        p_below > 0, _safe_log(p_below) - _safe_log(p_above), -torch.inf
    )
    llr = llr.expand(hit.shape)
    best = torch.argmax(torch.where(hit, llr, -torch.inf), dim=-1)
    score = torch.gather(llr, -1, best[..., None])[..., 0]
    return best.to(torch.float32), score


def ei_sweep_cat(cat_keys, pb, pa, n_cand):
    """Batched categorical EI sweep: ``[B, Dk]`` keys x ``[Dk, K]``
    posteriors -> (vals, scores) each ``[B, Dk]`` (category indices as
    floats, before the ``int_low`` offset)."""
    return ei_best_cat(cat_keys, pb, pa, n_cand)


def ei_scores_cat(key, p_below, p_above, n_cand):
    """Categorical dims, per-candidate form for the joint-EI path: draw
    ``n_cand`` categories per key from the below posteriors and return
    (category indices ``[..., S]`` as floats, llr ``[..., S]``).  The
    reference contracts the one-hot pick against an (index, llr) table;
    the pick is one-hot, so a gather gives the same bits."""
    u = R.uniform(key, (n_cand,))
    onehot = _inverse_cdf_onehot(u, cumsum_rows(torch.clamp(p_below, min=0.0), dim=-1))
    comp = torch.argmax(onehot, dim=-1)  # exactly one hit per sample
    # zero-weight options are never drawn; 0 keeps the table finite.  The
    # logs are XLA's (R._log), so the joint score's categorical terms are
    # the reference's bits
    log = lambda p: R._log(torch.clamp(p, min=F32_TINY))  # noqa: E731
    llr_k = torch.where(p_below > 0, log(p_below) - log(p_above), 0.0)
    llr = torch.gather(llr_k.expand(comp.shape[:-1] + llr_k.shape[-1:]), -1, comp)
    return comp.to(torch.float32), llr


def ei_sweep_cat_scores(cat_keys, pb, pa, n_cand):
    """Per-candidate form of :func:`ei_sweep_cat` for the joint-EI path:
    (vals, llrs) each ``[B, Dk, S]``."""
    return ei_scores_cat(cat_keys, pb, pa, n_cand)


# the q-group index tensors, one per (dims, device): made at the first
# sweep, so that a captured sweep copies nothing from the host
_GROUP_INDEX = {}


def _group_index(pos, device):
    k = (pos.tobytes(), device)
    t = _GROUP_INDEX.get(k)
    if t is None:
        t = _GROUP_INDEX[k] = torch.as_tensor(pos, dtype=torch.int64, device=device)
    return t


def ei_sweep_cont_candidates(q_np, consts, cont_keys, fit_arrays, n_cand):
    """Every continuous candidate and its EI log-likelihood ratio.

    Draws ``n_cand`` candidates per (trial, continuous dim) from the below
    model with that pair's key (``cont_keys [B, Dc, 2]``) and scores each
    against the below and the above mixtures.  Dims are partitioned by
    the static ``q > 0`` (``q_np``, host numpy): quantized dims score by
    bin mass (:func:`gmm_logpdf_quant_pre`), unquantized dims through
    :func:`hyperopt_tpu_torch.ops.gmm_scores.gmm_llr` -- the CUDA kernel
    on the card.  Returns (samples, llr), each ``[B, Dc, n_cand]``.

    Fits with a leading study axis (``[N, Dc, K]``, keys ``[N, B, Dc,
    2]``) score every study's unquantized candidates in ONE kernel launch
    (:func:`~hyperopt_tpu_torch.ops.gmm_scores.gmm_llr_stacked`); the
    outputs are ``[N, B, Dc, n_cand]``.
    """
    wb, mb, sb, wa, ma, sa = fit_arrays
    low, high, logspace, q = (consts[k] for k in ("low", "high", "logspace", "q"))
    pre_b = gmm_precompute(wb, mb, sb, low, high)
    pre_a = gmm_precompute(wa, ma, sa, low, high)
    n_lead = wb.dim() - 2
    sel = (slice(None),) * n_lead  # the study axis, if any

    def per_trial(pre):
        # a study's mixtures broadcast against its keys' trial axis
        return {k: v.unsqueeze(n_lead) for k, v in pre.items()} if n_lead else pre

    samples = trunc_gmm_sample_pre(cont_keys, per_trial(pre_b), low, high, logspace, q,
                                   n_cand)
    llr = torch.empty_like(samples)
    q_np = np.asarray(q_np)
    dev = samples.device
    for has_q, pos in ((False, np.flatnonzero(q_np <= 0)), (True, np.flatnonzero(q_np > 0))):
        if pos.size == 0:
            continue
        idx = _group_index(pos, dev)
        at = sel + (slice(None), idx)  # [..., B, group, S]
        x = samples[at]
        grp_b = {k: v[sel + (idx,)] for k, v in pre_b.items()}
        grp_a = {k: v[sel + (idx,)] for k, v in pre_a.items()}
        if has_q:
            args = (low[idx], high[idx], logspace[idx], q[idx])
            llr[at] = (gmm_logpdf_quant_pre(x, per_trial(grp_b), *args)
                       - gmm_logpdf_quant_pre(x, per_trial(grp_a), *args))
        elif n_lead:
            llr[at] = gmm_llr_stacked(x, logspace[idx], grp_b, grp_a)
        else:
            llr[at] = gmm_llr(x.contiguous(), logspace[idx], grp_b, grp_a)
    return samples, llr


#: the reference's name for the per-candidate continuous sweep of the
#: joint-EI path: (vals, llrs) each ``[B, Dc, S]``
ei_sweep_cont_scores = ei_sweep_cont_candidates


def ei_sweep_cont(q_np, consts, cont_keys, fit_arrays, n_cand):
    """Batched continuous EI sweep over all trials x continuous dims:
    (best value, best llr), each ``[B, Dc]`` in cont-dim order."""
    samples, llr = ei_sweep_cont_candidates(q_np, consts, cont_keys, fit_arrays, n_cand)
    best = torch.argmax(llr, dim=-1, keepdim=True)
    return (torch.gather(samples, -1, best)[..., 0],
            torch.gather(llr, -1, best)[..., 0])
