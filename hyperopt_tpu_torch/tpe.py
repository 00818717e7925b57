"""TPE suggest path of the PyTorch port: ``algo=hyperopt_tpu_torch.tpe.suggest``.

The counterpart of :mod:`hyperopt_tpu.tpe_jax`: one ask runs the
good/bad split, the adaptive-Parzen fits of every hyperparameter, the
truncated-GMM candidate draws, the EI log-likelihood-ratio scoring
(through the CUDA kernel of :mod:`hyperopt_tpu_torch.ops.gmm_scores` for
unquantized continuous dims) and the argmax as tensor ops on the
domain's device.  Defaults, key tree and candidate order are the
reference's, so the same seed suggests the same trials up to float
rounding.

Every mode of the reference's sequential driver is served: the
factorized and the ``joint_ei`` posteriors, ``speculative=k`` draws with
their ``max_stale`` budget, the ``resident`` history mirror with O(D)
delta tells, and ``fused`` asks that apply the pending tell and draw in
one step, pre-dispatched by the ``ask_ahead`` hook of :func:`fmin`.
Where the reference jits one XLA program, the port runs the same steps
as eager PyTorch operations on the current stream.
"""

from __future__ import annotations

import warnings
import weakref

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


def fused_state_io(fn):
    """The ``state_io`` form of a suggest function ``fn(key, *state,
    batch)``: ``(key, values, active, losses, valid, vcol, acol, loss,
    idx, batch) -> (values', active', losses', valid', new_values,
    new_active)`` -- the staged O(D) delta is written in place, then the
    suggestion is drawn from the updated state.  The delta write is pure
    data movement, so at equal state the stream is bitwise ``fn``'s."""

    def fused(key, values, active, losses, valid, vcol, acol, loss, idx, batch):
        state = K.apply_delta(values, active, losses, valid, vcol, acol, loss, idx)
        new_values, new_active = fn(key, *state, batch)
        return tuple(state) + (new_values, new_active)

    return fused


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

    The factorized step also serves a stack of studies, the body of the
    study-batched engine (:mod:`hyperopt_tpu_torch.serve.batched`): keys
    ``[N, 2]`` and a state with the same leading axis (``values [N, D,
    cap]``, ``losses [N, cap]``) give ``[N, D, B]``, study ``i``'s slice
    computed by the same operations as a solo call on its own state, and
    all studies' unquantized candidates scored in one kernel launch.  The
    joint step takes the same leading axis (the compiled loop's seed
    sweeps).

    ``joint_ei=True`` scores whole configurations: candidate s of a trial
    is the s-th draw of every dim, its score the sum of the llrs of the
    dims active in it, and the trial takes the best column.  Every dim
    draws ``n_cand`` candidates then (``n_cand_cat`` is ignored: the
    columns need one S).  ``state_io=True`` returns the fused tell+ask
    form (:func:`fused_state_io`).
    """
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

    def fn_factorized(key, values, active, losses, valid, batch):
        fits = K.fit_all_dims(c, values, active, losses, valid, gamma, lf_f,
                              pw, above_cap=a_cap)
        lead = key.shape[:-1]  # () for one study, (N,) for a stack
        new_values = torch.zeros(lead + (D, batch), dtype=torch.float32, device=ps.device)
        keys = R.split(key, max(batch * (Dc + Dk), 1))
        if fits["cont"] is not None:
            cont_keys = keys[..., : batch * Dc, :].reshape(lead + (batch, Dc, 2))
            cont_vals, _ = K.ei_sweep_cont(ps.q, c, cont_keys, fits["cont"], n_cand)
            new_values[..., c["cont_idx"], :] = cont_vals.transpose(-1, -2)
        if fits["cat"] is not None:
            pb, pa = fits["cat"]
            if lead:  # a study's posteriors broadcast against its trial axis
                pb, pa = pb.unsqueeze(len(lead)), pa.unsqueeze(len(lead))
            cat_keys = keys[..., batch * Dc: batch * (Dc + Dk), :].reshape(lead + (batch, Dk, 2))
            cat_vals, _ = K.ei_sweep_cat(cat_keys, pb, pa, n_cat)
            new_values[..., c["cat_idx"], :] = cat_vals.transpose(-1, -2) + c["int_low"][:, None]
        return new_values, ps.active_fn(new_values)

    def fn_joint(key, values, active, losses, valid, batch):
        fits = K.fit_all_dims(c, values, active, losses, valid, gamma, lf_f,
                              pw, above_cap=a_cap)
        lead = key.shape[:-1]  # () for one history, (S,) for a seed sweep
        keys = R.split(key, max(batch * (Dc + Dk), 1))
        shape = lead + (batch, D, n_cand)
        cand_values = torch.zeros(shape, dtype=torch.float32, device=ps.device)
        llrs = torch.zeros(shape, dtype=torch.float32, device=ps.device)
        if fits["cont"] is not None:
            cont_keys = keys[..., : batch * Dc, :].reshape(lead + (batch, Dc, 2))
            v, l = K.ei_sweep_cont_scores(ps.q, c, cont_keys, fits["cont"], n_cand)
            cand_values[..., c["cont_idx"], :] = v
            llrs[..., c["cont_idx"], :] = l
        if fits["cat"] is not None:
            pb, pa = fits["cat"]
            if lead:  # a seed's posteriors broadcast against its trial axis
                pb, pa = pb.unsqueeze(len(lead)), pa.unsqueeze(len(lead))
            cat_keys = keys[..., batch * Dc: batch * (Dc + Dk), :].reshape(lead + (batch, Dk, 2))
            v, l = K.ei_sweep_cat_scores(cat_keys, pb, pa, n_cand)
            cand_values[..., c["cat_idx"], :] = v + c["int_low"][:, None]
            llrs[..., c["cat_idx"], :] = l
        # configuration s = column s of every dim; only the dims active
        # in that configuration add to its joint score (summed in a fixed
        # order on the card, so a seed's slice keeps its solo bits)
        flat = cand_values.transpose(-3, -2).reshape(lead + (D, batch * n_cand))
        cand_active = ps.active_fn(flat).reshape(lead + (D, batch, n_cand)).transpose(-3, -2)
        joint = K.sum_rows(torch.where(cand_active, llrs, 0.0), dim=-2)  # [..., B, S]
        best = torch.argmax(joint, dim=-1)
        new_values = torch.gather(
            cand_values, -1, best[..., None, None].expand(lead + (batch, D, 1)))[..., 0]
        new_values = new_values.transpose(-1, -2)
        return new_values, ps.active_fn(new_values)

    fn = fn_joint if joint_ei else fn_factorized
    return fused_state_io(fn) if state_io else fn


def _cast_vals(ps, idxs, vals):
    """Dense float draws -> API types (ints for categorical-family dims)."""
    cat_labels = {ps.labels[d] for d in ps.cat_idx}
    for label in vals:
        if label in cat_labels:
            vals[label] = [int(round(v)) for v in vals[label]]
        else:
            vals[label] = [float(v) for v in vals[label]]
    return idxs, vals


def _to_host(values, active):
    return values.cpu().numpy(), active.cpu().numpy()


def _state_dispatch(buf, key, batch, pow2_cap, plain_fn, fused_fn):
    """Serve one dense draw over ``buf``, fusing the pending tell into it
    whenever the state allows -- the shared engine of every resident
    suggest path (TPE, :mod:`hyperopt_tpu_torch.anneal`, the speculative
    redraws).  With a resident buffer holding exactly one staged tell at
    an unchanged bucket, ``fused_fn`` writes the delta into the mirror
    and draws; otherwise the staged deltas (or a full upload) settle
    through :meth:`ObsBuffer.device_arrays` and ``plain_fn`` draws.  Both
    run the same suggest body on bitwise-equal state.  Returns DEVICE
    (values, active): no host sync, so the ask-ahead hook only enqueues.
    """
    if fused_fn is not None:
        fusable = buf.take_fusable_delta(pow2_cap)
        if fusable is not None:
            state, delta = fusable
            out = fused_fn(key, *state, *delta, batch)
            buf.commit_resident(out[:4])
            buf.dispatch_count += 1
            return out[4], out[5]
    arrays = buf.device_arrays(pow2_cap=pow2_cap)
    buf.dispatch_count += 1
    return plain_fn(key, *arrays, batch)


def _tpe_builder(ps_, nc, g, lf, pw, je, ncc, ac, sio):
    return build_suggest_fn(
        ps_, nc, g, lf, pw, joint_ei=je, n_cand_cat=ncc,
        above_cap=0 if ac is None else ac, state_io=sio,
    )


def _dense_dispatch(
    domain,
    trials,
    seed,
    batch,
    prior_weight=_default_prior_weight,
    n_startup_jobs=_default_n_startup_jobs,
    n_EI_candidates=_default_n_EI_candidates,
    gamma=_default_gamma,
    linear_forgetting=_default_linear_forgetting,
    joint_ei=False,
    n_EI_candidates_cat=_default_n_EI_candidates_cat,
    above_cap=None,
):
    """Device half of :func:`suggest_dense`: DEVICE (values, active),
    not waited for -- the ask-ahead hook calls this to enqueue the next
    ask right after a tell."""
    ps = packed_space_for(domain)
    buf = obs_buffer_for(domain, trials)
    key = R.key(int(seed) % (2**31 - 1), device=ps.device)

    if buf.count < n_startup_jobs:
        buf.dispatch_count += 1
        return ps.sample_prior(key, batch)

    n_cat = None if n_EI_candidates_cat is None else int(n_EI_candidates_cat)
    a_cap = _resolve_above_cap(above_cap)
    params = (int(n_EI_candidates), float(gamma), float(linear_forgetting),
              float(prior_weight), bool(joint_ei), n_cat, a_cap)
    fn = cached_suggest_fn(domain, "_tpe_torch_cache", params + (False,), _tpe_builder)
    fused = (cached_suggest_fn(domain, "_tpe_torch_cache", params + (True,), _tpe_builder)
             if buf.resident else None)
    # with compaction on, the scoring width is static past the cap, so
    # the device view stops pow2 re-bucketing there
    return _state_dispatch(buf, key, batch, a_cap, fn, fused)


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
    joint_ei=False,
    n_EI_candidates_cat=_default_n_EI_candidates_cat,
    above_cap=None,
):
    """Dense draws for a batch: (values [D, batch], active [D, batch]) as
    host numpy -- prior draws during startup, TPE after.  Over a resident
    buffer the staged tells ride along as O(D) deltas, fused into the
    draw when exactly one is pending."""
    return _to_host(*_dense_dispatch(
        domain, trials, seed, batch,
        prior_weight=prior_weight,
        n_startup_jobs=n_startup_jobs,
        n_EI_candidates=n_EI_candidates,
        gamma=gamma,
        linear_forgetting=linear_forgetting,
        joint_ei=joint_ei,
        n_EI_candidates_cat=n_EI_candidates_cat,
        above_cap=above_cap,
    ))


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
    joint_ei=False,
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
        joint_ei=joint_ei,
        n_EI_candidates_cat=n_EI_candidates_cat,
        above_cap=above_cap,
    )
    idxs, vals = dense_to_idxs_vals(new_ids, ps.labels, values, active)
    return _cast_vals(ps, idxs, vals)


def _saturated_categorical(ps, n_cat_total):
    """True when the k columns of a speculative draw would be near-
    duplicates: every dim is categorical-family and the candidate draw
    covers every option, so the per-dim EI argmax is deterministic given
    one posterior.  Callers degrade to one draw per ask with a warning."""
    return len(ps.cont_idx) == 0 and int(n_cat_total) >= int(ps.k_max)


def _warn_saturated(domain, k, advice=None):
    if getattr(domain, "_spec_saturation_warned", False):
        return
    domain._spec_saturation_warned = True
    if advice is None:
        advice = (
            "to keep speculation here, lower the categorical candidate "
            "count below the largest option count (draw randomness is "
            "the exploration mechanism on saturated categorical spaces)."
        )
    warnings.warn(
        f"speculative={k} disabled: every dimension of this space is "
        "categorical and the candidate draw covers every option, so the "
        "EI argmax is deterministic and the k speculative columns would "
        "be near-duplicate suggestions evaluated k times. Falling back "
        "to one dispatch per ask; " + advice,
        stacklevel=3,
    )


def _speculative_cols(domain, trials, seed, k, max_stale, params,
                      n_startup_jobs, draw_fn):
    """Serve one [D, 1] column from a k-wide speculative draw.

    One draw (``draw_fn(seed, k) -> (values, active)`` host numpy) makes
    ``k`` suggestion columns; later calls pop cached columns until the
    cache drains or the posterior has moved by more than ``max_stale``
    completed-ok observations since the draw (default ``k - 1``: the
    staleness of ``fmin(max_queue_len=k)``), or the startup/TPE regime
    flipped.  Prior-only callers pass an effectively infinite
    ``max_stale`` and skip the history sync.
    """
    if max_stale is None:
        max_stale = int(k) - 1
    if max_stale < 2**61:
        buf_count = obs_buffer_for(domain, trials).count  # syncs trials
        warm = buf_count >= n_startup_jobs
    else:
        buf_count = 0
        warm = True
    cache = getattr(domain, "_tpe_spec_draws", None)
    if cache is None:
        cache = {}
        domain._tpe_spec_draws = cache
    entry = cache.get(params)
    if entry is not None:
        stale = buf_count - entry["count_at_draw"]
        if (
            entry["trials_ref"]() is trials  # id() may alias after GC
            and 0 <= stale <= max_stale
            and entry["warm"] == warm
            and entry["next"] < entry["values"].shape[1]
        ):
            i = entry["next"]
            entry["next"] = i + 1
            return entry["values"][:, i: i + 1], entry["active"][:, i: i + 1]
    values, active = draw_fn(seed, k)
    cache[params] = {
        "trials_ref": weakref.ref(trials),
        "count_at_draw": buf_count,
        "warm": warm,
        "next": 1,
        "values": values,
        "active": active,
    }
    return values[:, :1], active[:, :1]


def _kw_key(kw):
    """Hashable identity of a suggest-kwarg dict (ask-ahead matching)."""
    return tuple(sorted((k, v) for k, v in kw.items()))


def _ask_ahead_state(domain):
    """The domain's ask-ahead record: the pending pre-dispatched draw,
    the kwargs its hook was installed for, and ``taken``, the asks that
    were served by a pre-dispatched draw."""
    st = getattr(domain, "_ask_ahead_state", None)
    if st is None:
        st = {"pending": None, "hook_key": None, "taken": 0}
        domain._ask_ahead_state = st
    return st


def _install_ask_ahead(domain, kw):
    """Register the sequential driver's result hook (idempotent per kw).

    :class:`~hyperopt_tpu_torch.fmin.FMinIter` calls it right after it
    records a result, with the seed it will hand the NEXT ask (pre-drawn
    from the same rstate stream, so the stream is the un-hooked one).
    The hook enqueues the fused tell+ask on the current stream without
    waiting; the next ``suggest(fused=True)`` finds the pending draw and
    only then copies it to the host.
    """
    st = _ask_ahead_state(domain)
    key = _kw_key(kw)
    if st["hook_key"] == key and getattr(domain, "_ask_ahead_hook", None):
        return

    def hook(trials, seed):
        out = _dense_dispatch(domain, trials, int(seed), 1, **kw)
        st["pending"] = {
            "seed": int(seed),
            "trials_ref": weakref.ref(trials),
            "count": obs_buffer_for(domain, trials).count,
            "kw_key": key,
            "out": out,
        }

    domain._ask_ahead_hook = hook
    st["hook_key"] = key


def _fused_ask(domain, trials, seed, kw, ask_ahead):
    """One sequential ask through the fused driver: take the draw the
    ask-ahead hook staged if it matches this ask, else draw now (fused
    with the pending tell where possible)."""
    if ask_ahead:
        _install_ask_ahead(domain, kw)
    st = _ask_ahead_state(domain)
    pending, st["pending"] = st["pending"], None
    buf = obs_buffer_for(domain, trials, resident=True)
    if (
        pending is not None
        and pending["seed"] == int(seed)
        and pending["trials_ref"]() is trials
        and pending["kw_key"] == _kw_key(kw)
        and pending["count"] == buf.count
    ):
        st["taken"] += 1
        return _to_host(*pending["out"])
    # no matching pre-dispatch: its tell stays committed, only the ask
    # runs again
    return _to_host(*_dense_dispatch(domain, trials, seed, 1, **kw))


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

    ``joint_ei=True`` scores whole configurations (:func:`build_suggest_fn`).
    ``speculative=k`` serves ``k`` sequential asks from one k-wide draw
    while the posterior is at most ``max_stale`` (default ``k - 1``)
    observations stale; on a saturated pure-categorical space it degrades
    to one draw per ask with a one-time warning.  ``resident=True`` keeps
    the history on the device with O(D) delta tells; the stream is
    bitwise the re-upload one.  ``fused=True`` (implies ``resident``)
    serves each sequential ask by one fused tell+ask and, under
    :func:`~hyperopt_tpu_torch.fmin.fmin`, pre-dispatches it when the
    previous result is recorded (``ask_ahead``, default on with
    ``fused``).
    """
    kw = dict(
        prior_weight=prior_weight,
        n_startup_jobs=n_startup_jobs,
        n_EI_candidates=n_EI_candidates,
        gamma=gamma,
        linear_forgetting=linear_forgetting,
        joint_ei=joint_ei,
        n_EI_candidates_cat=n_EI_candidates_cat,
        above_cap=above_cap,
    )
    if fused and resident is None:
        resident = True
    if resident is not None:
        obs_buffer_for(domain, trials, resident=bool(resident))
    ps = packed_space_for(domain)
    if fused and not speculative and len(new_ids) == 1:
        values, active = _fused_ask(
            domain, trials, seed, kw,
            ask_ahead=True if ask_ahead is None else bool(ask_ahead),
        )
    elif speculative and len(new_ids) == 1:
        n_cat_eff = n_EI_candidates if n_EI_candidates_cat is None else n_EI_candidates_cat
        if _saturated_categorical(ps, n_cat_eff):
            _warn_saturated(domain, speculative)
            return docs_from_idxs_vals(
                new_ids, domain, trials,
                *suggest_batch(new_ids, domain, trials, seed, **kw),
            )
        # every regime-determining knob plus the trials-store identity:
        # differently configured partials never serve each other's columns
        params = (
            int(n_EI_candidates), float(gamma), float(linear_forgetting),
            float(prior_weight), bool(joint_ei), int(speculative),
            int(n_startup_jobs), id(trials),
            None if n_EI_candidates_cat is None else int(n_EI_candidates_cat),
            int(speculative) - 1 if max_stale is None else int(max_stale),
            _resolve_above_cap(above_cap),
        )
        values, active = _speculative_cols(
            domain, trials, seed, int(speculative), max_stale, params,
            n_startup_jobs,
            lambda s, k: suggest_dense(domain, trials, s, k, **kw),
        )
    else:
        return docs_from_idxs_vals(
            new_ids, domain, trials,
            *suggest_batch(new_ids, domain, trials, seed, **kw),
        )
    idxs, vals = dense_to_idxs_vals(new_ids, ps.labels, values, active)
    return docs_from_idxs_vals(new_ids, domain, trials, *_cast_vals(ps, idxs, vals))


# ---------------------------------------------------------------------------
# Program registrations (hyperopt-tpu-torch-lint --ir): TPE's programs
# ---------------------------------------------------------------------------

from .ops.compile import ProgramCapture, register_program  # noqa: E402

_TPE_FAMILIES = ("hyperopt_tpu_torch.tpe:build_suggest_fn",
                 "hyperopt_tpu_torch.tpe:fused_state_io")


def _registry_build(ps, n_cand, state_io=False):
    return build_suggest_fn(
        ps, n_cand, _default_gamma, _default_linear_forgetting, _default_prior_weight,
        n_cand_cat=_default_n_EI_candidates_cat, state_io=state_io,
    )


@register_program("tpe.suggest", families=_TPE_FAMILIES)
def _registry_tpe_suggest(p):
    """The plain batched ask: one launch sequence draws ``batch``
    suggestions from the settled history (``suggest_batch`` /
    ``suggest_dense``)."""
    return ProgramCapture(
        fn=_registry_build(p.space, _default_n_EI_candidates),
        args=(p.key_spec(),) + p.history_specs(), kwargs={"batch": p.batch},
    )


@register_program("tpe.fused_tell_ask", families=_TPE_FAMILIES)
def _registry_tpe_fused(p):
    """The ``state_io=True`` fused tell+ask of the sequential driver: the
    staged O(D) delta written into the resident history in place, then
    one ask from it (one launch sequence per trial)."""
    return ProgramCapture(
        fn=_registry_build(p.space, _default_n_EI_candidates, state_io=True),
        args=(p.key_spec(),) + p.history_specs(),
        kwargs={**p.delta_specs(), "batch": 1}, mutates=(1, 2, 3, 4),
        # the suggest closure of tpe.suggest behind the delta write of
        # torch_trials.apply_delta: both pin their GL402 behavior
        x64_check=False,
    )


@register_program("tpe.speculative_redraw", families=_TPE_FAMILIES)
def _registry_tpe_speculative(p):
    """The k-wide speculative draw (``suggest(speculative=k)``): the suggest
    program at ``batch=k``, pinned on its own because its output shapes
    are the speculation cache's layout."""
    return ProgramCapture(
        fn=_registry_build(p.space, _default_n_EI_candidates),
        args=(p.key_spec(),) + p.history_specs(), kwargs={"batch": p.k_spec},
        # tpe.suggest's closure at another batch: its GL402 behavior is
        # pinned there
        x64_check=False,
    )
