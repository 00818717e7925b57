"""Rank-sharded TPE suggest: the candidate sweep split across ranks.

The counterpart of :mod:`hyperopt_tpu.parallel.sharded`.  The Parzen
fits are tiny and every rank computes them from its own copy of the
history; the expensive part -- drawing and scoring the EI candidates of
every hyperparameter -- shards over the mesh's ``cand`` axis.  Each rank
draws its own candidate slab from the key folded by its position on
that axis (the reference folds by ``lax.axis_index``), scores it on its
own device (continuous dims through the ``gmm_llr`` kernel) and packs
its per-dim (value, score) winners; ONE all-gather per step brings every
rank's pairs to every rank, and the argmax over ranks (the first rank
wins a tie) picks the global winner.  Total candidates per dim =
``n_cand_per_device * mesh.shape['cand']``.

One rank is :func:`hyperopt_tpu_torch.tpe.build_suggest_fn` at the key
``fold_in(key, 0)``.  Several ranks are several processes that joined
one ``torch.distributed`` group (:mod:`.multihost`), or the ranks of a
:func:`~.mesh.virtual_mesh` computed in turn inside one process; both
give the same bits.  Under ``gloo`` the packed pairs (``B x D x 2``
floats, a few hundred bytes) go through the host for the gather and
back to the device: every draw and score still runs on the rank's
device.

The sweep is also the model step of ``compile_fmin(mesh=,
cand_axis=)`` and of ``atpe.build_atpe_device_fn(mesh=, cand_axis=)``.
On a virtual mesh the ranks' bodies and the reduction run in turn inside
the one captured step, with no host read.  Over real ranks the compiled
loop splits the step at the packed winners (the step's ``local`` and
``reduce`` halves): one captured graph draws and scores this rank's
slab, the host gathers the winners of the ``cand`` line, and a second
graph reduces them.  Keys with a
leading seed axis (``[S, 2]``, a history ``[S, D, cap]``) sweep S
experiments at once, each seed's slice by the same operations as its
solo call.
"""

from __future__ import annotations

import torch

from .. import random as R
from ..ops import kernels as K
from ..rand import docs_from_idxs_vals
from ..torch_trials import cached_suggest_fn, obs_buffer_for, packed_space_for
from ..vectorize import dense_to_idxs_vals
from .mesh import CAND_AXIS, default_mesh
from .multihost import process_count, process_index

__all__ = [
    "build_local_best",
    "build_sharded_suggest_fn",
    "build_sharded_sweep",
    "per_device_count",
    "reduce_best",
    "sharded_draw",
    "sharded_suggest",
    "suggest",
]


def per_device_count(total, n_dev):
    """Per-device slab width for a TOTAL sweep width: round up, floor at
    1 -- the executed total may exceed the request by < n_dev.  THE
    single definition of the total->per-device contract, shared by every
    sharded-sweep entry point (plain, adaptive, device-loop)."""
    return max(1, -(-int(total) // int(n_dev)))


def build_local_best(ps, n_cand_per_device, n_cand_cat_per_device=None):
    """The per-rank body of the sharded sweep:
    ``local_best(key, fits, batch, rank) -> [B, Dc+Dk, 2]``, each dim's
    winning (value, score) over the rank's own candidate slab, continuous
    dims first.  ``rank`` is the rank's position on the ``cand`` axis;
    ``fits`` is :func:`~hyperopt_tpu_torch.ops.kernels.fit_all_dims`'s
    output."""
    c = ps.consts
    Dc = len(ps.cont_idx)
    Dk = len(ps.cat_idx)
    n_cat = (int(n_cand_per_device) if n_cand_cat_per_device is None
             else max(1, int(n_cand_cat_per_device)))

    def local_best(key, fits, batch, rank):
        lead = key.shape[:-1]  # () for one history, (S,) for a seed sweep
        keys = R.split(R.fold_in(key, int(rank)), max(batch * (Dc + Dk), 1))
        vals, scores = [], []
        if Dc:
            cont_keys = keys[..., : batch * Dc, :].reshape(lead + (batch, Dc, 2))
            v, s = K.ei_sweep_cont(ps.q, c, cont_keys, fits["cont"], n_cand_per_device)
            vals.append(v)
            scores.append(s)
        if Dk:
            pb, pa = fits["cat"]
            if lead:  # a seed's posteriors broadcast against its trial axis
                pb, pa = pb.unsqueeze(len(lead)), pa.unsqueeze(len(lead))
            cat_keys = keys[..., batch * Dc: batch * (Dc + Dk), :].reshape(lead + (batch, Dk, 2))
            v, s = K.ei_sweep_cat(cat_keys, pb, pa, n_cat)
            vals.append(v)
            scores.append(s)
        return torch.stack([torch.cat(vals, dim=-1), torch.cat(scores, dim=-1)], dim=-1)

    return local_best


def reduce_best(ps, gathered):
    """Every rank's packed winners ``[W, ..., B, Dc+Dk, 2]`` (in rank
    order) -> ``(new_values [..., D, B], active)``: the argmax over ranks,
    the first rank winning a tie, with ``int_low`` added back on the
    categorical dims."""
    c = ps.consts
    Dc = len(ps.cont_idx)
    win = torch.argmax(gathered[..., 1], dim=0)  # [..., B, Dc+Dk]
    best = torch.gather(gathered[..., 0], 0, win[None])[0]
    new_values = torch.zeros(best.shape[:-2] + (ps.n_dims, best.shape[-2]),
                             dtype=torch.float32, device=best.device)
    if Dc:
        new_values[..., c["cont_idx"], :] = best[..., :Dc].transpose(-1, -2)
    if len(ps.cat_idx):
        new_values[..., c["cat_idx"], :] = (best[..., Dc:].transpose(-1, -2)
                                            + c["int_low"][:, None])
    return new_values, ps.active_fn(new_values)


def _all_gather(packed, mesh, axis, rank):
    """ONE ``all_gather`` of this rank's packed winners over the line of
    ``axis`` through ``rank``: ``[W, B, C, 2]`` on ``packed``'s device."""
    import torch.distributed as dist

    if process_count() == 1:
        raise RuntimeError(
            f"{mesh!r} spans {mesh.shape[axis]} ranks on {axis!r}, but no process group is "
            "initialized: join one with parallel.multihost.initialize, or compute the ranks "
            "in this process on parallel.mesh.virtual_mesh")
    group = mesh.group(axis, rank)
    wire = packed if dist.get_backend(group) == "nccl" else packed.cpu()
    parts = [torch.empty_like(wire) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, wire.contiguous(), group=group)
    return torch.stack(parts).to(packed.device)


def build_sharded_sweep(ps, mesh, n_cand_per_device, axis=CAND_AXIS,
                        n_cand_cat_per_device=None):
    """The rank-sharded EI candidate sweep, taking precomputed fits:
    ``sweep(key, fits, batch) -> (new_values [D, B], active)``.  This
    rank runs :func:`build_local_best`'s body at its position on
    ``axis``, one all-gather collects every rank's winners, and
    :func:`reduce_best` picks among them (a virtual mesh runs every
    rank's body here instead of the gather)."""
    local_best = build_local_best(ps, n_cand_per_device, n_cand_cat_per_device)
    width = int(mesh.shape[axis])

    def sweep(key, fits, batch):
        if mesh.virtual:
            gathered = torch.stack([local_best(key, fits, batch, r) for r in range(width)])
        else:
            rank = process_index()
            packed = local_best(key, fits, batch, mesh.axis_index(axis, rank))
            gathered = packed[None] if width == 1 else _all_gather(packed, mesh, axis, rank)
        return reduce_best(ps, gathered)

    # the two halves, for a step split at the packed winners (the compiled
    # loop's axis over processes, a host gather between two graphs):
    # ``local(key, fits, batch, rank)`` and ``reduce(gathered)``
    sweep.local = local_best
    sweep.reduce = lambda gathered: reduce_best(ps, gathered)
    return sweep


def build_sharded_suggest_fn(
    ps, mesh, n_cand_per_device, gamma, lf, prior_weight, axis=CAND_AXIS,
    n_cand_cat_per_device=None, above_cap=None,
):
    """The rank-sharded TPE step for a PackedSpace:
    ``fn(key, values, active, losses, valid, batch)`` like
    :func:`hyperopt_tpu_torch.tpe.build_suggest_fn`, with the candidate
    sweep sharded over ``axis`` of ``mesh``.

    ``n_cand_cat_per_device`` (None = follow ``n_cand_per_device``) caps
    each rank's categorical draw: the union of the per-rank draws is
    statistically one draw of their total, and the categorical EI argmax
    saturates into pure exploitation once that total covers every option,
    so callers keep the TOTAL near the reference's 24.  ``above_cap``
    follows :func:`~hyperopt_tpu_torch.tpe._resolve_above_cap`.
    """
    from ..tpe import _resolve_above_cap

    K.check_prior_weight(prior_weight)
    c = ps.consts
    gamma = float(gamma)
    lf_f = float(lf)
    pw = float(prior_weight)
    a_cap = _resolve_above_cap(above_cap)
    sweep = build_sharded_sweep(ps, mesh, n_cand_per_device, axis=axis,
                                n_cand_cat_per_device=n_cand_cat_per_device)

    def fits_of(values, active, losses, valid):
        return K.fit_all_dims(c, values, active, losses, valid, gamma, lf_f, pw,
                              above_cap=a_cap)

    def fn(key, values, active, losses, valid, batch):
        return sweep(key, fits_of(values, active, losses, valid), batch)

    def local(key, values, active, losses, valid, batch, rank):
        """The first half: this rank's packed winners, as a one-tuple."""
        return (sweep.local(key, fits_of(values, active, losses, valid), batch, rank),)

    def reduce(key, values, active, losses, valid, batch, gathered, ctx):
        """The second half: every rank's winners ``[W, ..., B, Dc+Dk, 2]``
        -> ``(new_values, active)``."""
        return sweep.reduce(gathered)

    # the step split at the packed winners (see build_sharded_sweep)
    fn.local, fn.reduce = local, reduce
    return fn


def _build_sharded(ps_, mesh, n_pd, g, lf_, pw_, cpd, ac):
    return build_sharded_suggest_fn(ps_, mesh, n_pd, g, lf_, pw_, n_cand_cat_per_device=cpd,
                                    above_cap=0 if ac is None else ac)


def sharded_draw(domain, buf, mesh, cache_attr, n_per_dev, gamma, lf,
                 prior_weight, cat_per_dev, key, batch, above_cap=None):
    """One warm-path sharded draw as host numpy ``(values, active)``: the
    step cached on the domain under every knob and the mesh, fed the
    buffer's own device arrays (every rank holds its own copy of the
    history)."""
    from ..tpe import _resolve_above_cap, _to_host

    a_cap = _resolve_above_cap(above_cap)
    fn = cached_suggest_fn(
        domain, cache_attr,
        (mesh, int(n_per_dev), float(gamma), float(lf), float(prior_weight), cat_per_dev,
         a_cap),
        _build_sharded,
    )
    return _to_host(*fn(key, *buf.device_arrays(pow2_cap=a_cap), batch))


# ---------------------------------------------------------------------------
# drop-in suggest over a default all-ranks mesh
# ---------------------------------------------------------------------------

_default_n_EI_per_device = 64
# TOTAL categorical draw across the mesh; the union of per-rank draws is
# statistically one (per_rank x n_ranks)-draw sweep, and the categorical
# EI argmax saturates into pure exploitation once that total covers every
# option, so the default keeps the reference's 24 whatever the mesh size
_default_n_EI_cat_total = 24
_default_gamma = 0.25
_default_n_startup_jobs = 20
_default_linear_forgetting = 25
_default_prior_weight = 1.0


def sharded_suggest(
    new_ids,
    domain,
    trials,
    seed,
    mesh=None,
    n_EI_per_device=_default_n_EI_per_device,
    n_EI_cat_total=_default_n_EI_cat_total,
    prior_weight=_default_prior_weight,
    n_startup_jobs=_default_n_startup_jobs,
    gamma=_default_gamma,
    linear_forgetting=_default_linear_forgetting,
    speculative=0,
    max_stale=None,
    above_cap=None,
):
    """``algo=parallel.sharded_suggest``: TPE with the candidate sweep
    sharded over every rank (the domain's device unless the caller asks
    for the CPU).  ``n_EI_cat_total`` caps the TOTAL categorical draw
    (split across ranks); None follows ``n_EI_per_device`` on every rank.
    ``speculative=k`` serves k sequential asks from one mesh-wide draw
    (the cache semantics of :func:`hyperopt_tpu_torch.tpe.suggest`).
    ``above_cap`` follows :func:`hyperopt_tpu_torch.tpe.suggest`'s
    above-model compaction knob.  Every rank calls it with the same
    arguments and history, and gets the same docs."""
    from ..tpe import (_cast_vals, _resolve_above_cap, _saturated_categorical,
                       _speculative_cols, _to_host, _warn_saturated)

    ps = packed_space_for(domain)
    buf = obs_buffer_for(domain, trials)
    B = len(new_ids)

    if mesh is None:
        mesh = getattr(domain, "_tpe_mesh", None)
        if mesh is None:
            mesh = default_mesh()
            domain._tpe_mesh = mesh
    n_dev = int(mesh.shape[CAND_AXIS])
    cat_per_dev = None if n_EI_cat_total is None else per_device_count(n_EI_cat_total, n_dev)

    def draw(seed_, batch):
        key = R.key(int(seed_) % (2**31 - 1), device=ps.device)
        if buf.count < n_startup_jobs:
            return _to_host(*ps.sample_prior(key, batch))
        return sharded_draw(
            domain, buf, mesh, "_sharded_tpe_cache", n_EI_per_device, gamma,
            linear_forgetting, prior_weight, cat_per_dev, key, batch, above_cap=above_cap,
        )

    if speculative and B == 1:
        # the ACTUAL total categorical draw across the mesh decides
        # saturation: per-rank counts round up, so the executed total
        # (cat_per_dev * n_dev) can exceed the requested n_EI_cat_total
        n_cat_total = (int(n_EI_per_device) if cat_per_dev is None else cat_per_dev) * n_dev
        if _saturated_categorical(ps, n_cat_total):
            _warn_saturated(domain, speculative)
            speculative = 0

    if speculative and B == 1:
        params = (
            "sharded", mesh, int(n_EI_per_device), cat_per_dev,
            float(gamma), float(linear_forgetting), float(prior_weight),
            int(n_startup_jobs), id(trials), int(speculative),
            int(speculative) - 1 if max_stale is None else int(max_stale),
            _resolve_above_cap(above_cap),
        )
        values, active = _speculative_cols(
            domain, trials, seed, int(speculative), max_stale, params, n_startup_jobs, draw,
        )
    else:
        values, active = draw(seed, B)

    idxs, vals = dense_to_idxs_vals(new_ids, ps.labels, values, active)
    idxs, vals = _cast_vals(ps, idxs, vals)
    return docs_from_idxs_vals(new_ids, domain, trials, idxs, vals)


suggest = sharded_suggest


# ---------------------------------------------------------------------------
# Program registration (hyperopt-tpu-torch-lint --ir)
# ---------------------------------------------------------------------------

from ..ops.compile import ProgramCapture, register_program  # noqa: E402


@register_program(
    "sharded.suggest",
    families=("hyperopt_tpu_torch.parallel.sharded:build_sharded_suggest_fn",
              "hyperopt_tpu_torch.parallel.sharded:build_sharded_sweep"),
)
def _registry_sharded_suggest(p):
    """The rank-sharded candidate sweep over a one-rank mesh: the
    per-rank draw and the winners' reduction are rank-count-independent,
    so the one-rank graph pins the program every mesh runs."""
    from .mesh import virtual_mesh

    fn = build_sharded_suggest_fn(
        p.space, virtual_mesh(1), _default_n_EI_per_device, _default_gamma,
        _default_linear_forgetting, _default_prior_weight,
        n_cand_cat_per_device=_default_n_EI_cat_total,
    )
    return ProgramCapture(fn=fn, args=(p.key_spec(),) + p.history_specs(),
                          kwargs={"batch": 1})
