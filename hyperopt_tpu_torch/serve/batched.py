"""The study-batched device engine of the PyTorch port: one launch
sequence serves N studies.

The counterpart of :mod:`hyperopt_tpu.serve.batched`.  N independent
studies' histories are stacked along a leading study axis
(:class:`StudyBatchState`) and one step applies every slot's staged O(D)
tell delta AND draws every slot's next suggestion -- the fused tell+ask
of the sequential ``fmin`` loop, amortized across tenants.  Where the reference
``vmap``\\ s its per-study closure, the port's suggest bodies take the
study axis explicitly (``tpe.build_suggest_fn`` and
``anneal.build_anneal_fn`` accept keys ``[N, 2]`` with an ``[N, ...]``
state), so the step's launch sequence does not grow with N, and all
studies' unquantized continuous candidates are scored by ONE launch of
the ``gmm_llr`` kernel
(:func:`~hyperopt_tpu_torch.ops.gmm_scores.gmm_llr_stacked`).

Parity contract: slot ``i`` runs the same operations as the solo fused
path on study ``i``'s state alone -- the delta write is
:func:`~hyperopt_tpu_torch.ops.kernels.apply_delta_stacked` (bitwise
``apply_delta`` where the mask applies), and regime selection is an
elementwise ``where`` between the warm suggestion and the prior draw of
the same per-study key.  Bitwise equality then holds where each
operation's per-row result does not depend on the rows beside it; the
tests hold it on the CPU, ``chip_smoke.py`` counts it on the card.

Shape discipline: all studies share one space, one history width (the
widest study's bucket) and one pow2 slot capacity.  The state is written
IN PLACE (the reference donates it instead): a re-materialization always
allocates new tensors.

``mesh=`` (the study axis sharded over several cards) raises until
``ROADMAP.md`` Queue A item 15.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernels as K

__all__ = [
    "MIN_SLOTS",
    "StudyBatchState",
    "build_batched_delta_fn",
    "build_batched_step_fn",
    "build_finite_check_fn",
    "restack_shards",
    "slot_capacity",
    "stack_states",
]

#: smallest slot capacity a batch is allocated at; capacities grow by
#: pow2 doubling up to the scheduler's ``max_batch``
MIN_SLOTS = 4


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "the serve engine's mesh= (the study axis sharded over several "
            "cards) is not ported yet: ROADMAP.md Queue A item 15"
        )


class StudyBatchState(NamedTuple):
    """N stacked :class:`~hyperopt_tpu_torch.ops.kernels.HistoryState`\\ s:
    the four dense history tensors with a leading study axis.  Slot ``i``
    IS study ``i``'s ``HistoryState``; freed slots hold garbage behind
    the scheduler's active-slot mask and are never read back."""

    values: torch.Tensor  # [S, D, cap] natural-space draws
    active: torch.Tensor  # [S, D, cap] per-dim activity mask
    losses: torch.Tensor  # [S, cap]
    valid: torch.Tensor   # [S, cap] slot occupancy (per-study prefix mask)


def slot_capacity(n_studies, max_batch):
    """The slot capacity a batch of ``n_studies`` runs at: pow2 doubling
    from :data:`MIN_SLOTS`, clamped to ``max_batch``."""
    cap = MIN_SLOTS
    while cap < n_studies and cap < max_batch:
        cap <<= 1
    return min(cap, max_batch)


def _host_stack(buffers, slot_cap, bucket, n_dims):
    """The four stacked host arrays for ``slot_cap`` slots at ``bucket``
    width; slots without a buffer stay zero (invalid)."""
    s, b, d = int(slot_cap), int(bucket), int(n_dims)
    values = np.zeros((s, d, b), dtype=np.float32)
    active = np.zeros((s, d, b), dtype=bool)
    losses = np.zeros((s, b), dtype=np.float32)
    valid = np.zeros((s, b), dtype=bool)
    for i, buf in buffers.items():
        # a sibling's host capacity may trail the batch bucket (the
        # bucket tracks the LARGEST study); its tail stays zero/invalid
        w = min(buf.values.shape[1], b)
        values[i, :, :w] = buf.values[:, :w]
        active[i, :, :w] = buf.active[:, :w]
        losses[i, :w] = buf.losses[:w]
        valid[i, :w] = buf.valid[:w]
    return values, active, losses, valid


def stack_states(buffers, slot_cap, bucket, device):
    """Stack per-study host buffers into a :class:`StudyBatchState` on
    ``device``: ``buffers`` maps slot index -> ObsBuffer (missing slots
    are zero history).  One upload per tensor, into NEW tensors that
    share no memory with the host arrays or with any earlier state.
    Returns ``(state, nbytes)``."""
    d = next((buf.space.n_dims for buf in buffers.values()), None)
    if d is None:
        raise ValueError("stack_states needs at least one study buffer")
    arrays = _host_stack(buffers, slot_cap, bucket, d)
    nbytes = sum(a.nbytes for a in arrays)
    return StudyBatchState(*(torch.tensor(a, device=device) for a in arrays)), nbytes


def restack_shards(*args, **kwargs):
    """Shard-local re-materialization of a sharded batch: not ported."""
    raise NotImplementedError(
        "restack_shards (shard-local re-materialization of a mesh-sharded "
        "batch) is not ported yet: ROADMAP.md Queue A item 15"
    )


def _dummy_delta(ps, slot_cap):
    """Host-side no-op delta rows for slots with nothing staged (the
    ``apply=False`` mask makes them pure pass-through on the device)."""
    d, s = ps.n_dims, int(slot_cap)
    return (
        np.zeros((s, d), dtype=np.float32),
        np.zeros((s, d), dtype=bool),
        np.zeros((s,), dtype=np.float32),
        np.zeros((s,), dtype=np.int64),
        np.zeros((s,), dtype=bool),
    )


def build_batched_step_fn(ps, algo="tpe", n_cand=16, gamma=0.25, lf=25.0,
                          prior_weight=1.0, n_cand_cat=None, above_cap=None,
                          avg_best_idx=2.0, shrink_coef=0.1, mesh=None):
    """The batched fused tell+ask step for a PackedSpace (built once per
    parameterization, cached on the space).

    Returns ``fn(keys, values, active, losses, valid, vcol, acol, loss,
    idx, apply, warm, batch) -> (values', active', losses', valid',
    new_values [S, D, B], new_active [S, D, B])``: ``keys`` ``[S, 2]``,
    the state ``[S, ...]`` (written in place), the delta rows ``[S, D]``
    / ``[S]`` and the ``warm`` mask ``[S]``, as tensors or host arrays.

    Per slot: the staged delta applies where ``apply`` is set, then the
    suggestion is drawn from the updated slot state -- by the algorithm
    where ``warm`` is set, by the prior otherwise (the startup regime),
    both from the SAME per-slot key.  Slots without a pending ask get a
    placeholder key; their columns are never read back.

    ``algo`` is ``"tpe"`` (:func:`hyperopt_tpu_torch.tpe.build_suggest_fn`,
    factorized) or ``"anneal"``
    (:func:`hyperopt_tpu_torch.anneal.build_anneal_fn`).
    """
    _no_mesh(mesh)
    cache_key = (
        str(algo), int(n_cand), float(gamma), float(lf), float(prior_weight),
        None if n_cand_cat is None else int(n_cand_cat),
        None if above_cap is None else int(above_cap),
        float(avg_best_idx), float(shrink_coef),
    )
    cache = getattr(ps, "_serve_step_cache", None)
    if cache is None:
        cache = ps._serve_step_cache = {}
    cached = cache.get(cache_key)
    if cached is not None:
        return cached

    if algo == "tpe":
        from ..tpe import _resolve_above_cap, build_suggest_fn

        a_cap = _resolve_above_cap(above_cap)
        core = build_suggest_fn(
            ps, int(n_cand), float(gamma), float(lf), float(prior_weight),
            n_cand_cat=n_cand_cat, above_cap=0 if a_cap is None else a_cap,
        )
    elif algo == "anneal":
        from ..anneal import build_anneal_fn

        core = build_anneal_fn(ps, float(avg_best_idx), float(shrink_coef))
    else:
        raise ValueError(f"unknown serve algo {algo!r}")

    def step(keys, values, active, losses, valid, vcol, acol, loss, idx, apply, warm,
             batch):
        dev = values.device
        keys = torch.as_tensor(keys, dtype=torch.int64, device=dev)
        st = K.apply_delta_stacked(values, active, losses, valid, vcol, acol, loss, idx,
                                   apply)
        warm_v, warm_a = core(keys, *st, batch)
        pri_v, pri_a = ps.sample_prior_fn(keys, batch)
        wm = torch.as_tensor(warm, dtype=torch.bool, device=dev)[:, None, None]
        return tuple(st) + (torch.where(wm, warm_v, pri_v), torch.where(wm, warm_a, pri_a))

    cache[cache_key] = step
    return step


def _finite_check(values, active, losses, valid, new_v):
    v_ok = torch.isfinite(torch.where(active, values, 0.0)).flatten(1).all(dim=1)
    l_ok = torch.isfinite(torch.where(valid, losses, 0.0)).all(dim=1)
    s_ok = torch.isfinite(new_v).flatten(1).all(dim=1)
    return ~(v_ok & l_ok & s_ok)


def build_finite_check_fn(mesh=None):
    """The poisoned-slot detector: ``fn(values, active, losses, valid,
    new_v) -> poisoned [S] bool``.  A slot is poisoned when any active
    history value, any valid loss, or any of this round's suggestion
    columns is non-finite; masked positions (inactive dims, empty
    history slots) are exempt, so a freed slot's garbage never trips a
    healthy tenant.  Read-only."""
    _no_mesh(mesh)
    return _finite_check


def build_batched_delta_fn(mesh=None):
    """The stacked twin of the O(D) delta tell: ``fn(values, active,
    losses, valid, vcol, acol, loss, idx, apply)`` writes at most one
    staged delta per slot, each at its own index, in one gather/scatter
    per state tensor (in place) -- the backlog drain for a study that
    told more than once between asks."""
    _no_mesh(mesh)
    return K.apply_delta_stacked
