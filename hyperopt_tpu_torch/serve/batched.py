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

``mesh=`` shards the slot axis over a 1-D ``study`` mesh inside this
process (:func:`~hyperopt_tpu_torch.parallel.mesh.virtual_mesh`, or a
mesh of one rank): the capacity rounds up to a multiple of the shard
count (:func:`slot_capacity` ``shards=``), and each shard is its own
:class:`StudyBatchState` over its block of slots, all on the engine's
device (:class:`ShardedBatchState`; shards on several cards are refused,
:func:`~hyperopt_tpu_torch.parallel.mesh.shard_devices`).  A round runs the unsharded step over every
block in turn -- one ``gmm_llr_stacked`` launch per shard -- and slots
never interact, so every slot's bits are the unsharded engine's.
:func:`restack_shards` rebuilds only dirty shards: a clean shard keeps
its very tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernels as K

__all__ = [
    "MIN_SLOTS",
    "ShardedBatchState",
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


class StudyBatchState(NamedTuple):
    """N stacked :class:`~hyperopt_tpu_torch.ops.kernels.HistoryState`\\ s:
    the four dense history tensors with a leading study axis.  Slot ``i``
    IS study ``i``'s ``HistoryState``; freed slots hold garbage behind
    the scheduler's active-slot mask and are never read back."""

    values: torch.Tensor  # [S, D, cap] natural-space draws
    active: torch.Tensor  # [S, D, cap] per-dim activity mask
    losses: torch.Tensor  # [S, cap]
    valid: torch.Tensor   # [S, cap] slot occupancy (per-study prefix mask)


class ShardedBatchState(NamedTuple):
    """A :class:`StudyBatchState` whose slot axis is cut into equal
    blocks, one per shard: each field holds the shards' tensors in shard
    order, and :meth:`shard` is shard ``k``'s own
    :class:`StudyBatchState` (slots ``k * blk`` to ``(k + 1) * blk``)."""

    values: tuple
    active: tuple
    losses: tuple
    valid: tuple

    @property
    def n_shards(self):
        return len(self.values)

    def shard(self, k):
        return StudyBatchState(*(field[k] for field in self))

    def gathered(self, field):
        """One field's shards joined along the slot axis."""
        return torch.cat(getattr(self, field))


def slot_capacity(n_studies, max_batch, shards=1):
    """The slot capacity a batch of ``n_studies`` runs at: pow2 doubling
    from :data:`MIN_SLOTS`, clamped to ``max_batch``, then rounded UP to a
    multiple of ``shards`` (the study axis's shard count), so the slots
    always split evenly; the rounding pads dead slots behind the active
    mask and never drops live ones."""
    cap = MIN_SLOTS
    while cap < n_studies and cap < max_batch:
        cap <<= 1
    cap = min(cap, max_batch)
    m = max(1, int(shards))
    return -(-cap // m) * m


def mesh_shards(mesh, axis=None, device=None):
    """``(axis, n_shards)`` of a study ``mesh`` inside this process
    (``axis`` None: the mesh's one axis), every shard on ``device``."""
    from ..parallel.mesh import STUDY_AXIS, in_process_shards

    ax = axis or (next(iter(mesh.shape)) if len(mesh.shape) == 1 else STUDY_AXIS)
    return ax, in_process_shards(mesh, ax, "the serve engine's mesh=", device)


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


def stack_states(buffers, slot_cap, bucket, device, mesh=None, axis=None):
    """Stack per-study host buffers into a :class:`StudyBatchState` on
    ``device``: ``buffers`` maps slot index -> ObsBuffer (missing slots
    are zero history).  One upload per tensor, into NEW tensors that
    share no memory with the host arrays or with any earlier state.
    With ``mesh=`` the slots split into the mesh's blocks, each uploaded
    on its own (a :class:`ShardedBatchState`).  Returns ``(state,
    nbytes)``."""
    d = next((buf.space.n_dims for buf in buffers.values()), None)
    if d is None:
        raise ValueError("stack_states needs at least one study buffer")
    if mesh is None:
        arrays = _host_stack(buffers, slot_cap, bucket, d)
        nbytes = sum(a.nbytes for a in arrays)
        return StudyBatchState(*(torch.tensor(a, device=device) for a in arrays)), nbytes
    _, n = mesh_shards(mesh, axis, device)
    blk = int(slot_cap) // n
    shards, nbytes = [], 0
    for k in range(n):
        lo = k * blk
        sub = {i - lo: buf for i, buf in buffers.items() if lo <= i < lo + blk}
        arrays = _host_stack(sub, blk, bucket, d)
        nbytes += sum(a.nbytes for a in arrays)
        shards.append([torch.tensor(a, device=device) for a in arrays])
    return ShardedBatchState(*(tuple(f) for f in zip(*shards))), nbytes


def restack_shards(state, buffers, slot_cap, bucket, n_dims, mesh, axis, dirty_shards):
    """Shard-local re-materialization: rebuild ONLY the ``dirty_shards``
    (shard ordinals) of the :class:`ShardedBatchState` ``state`` from host
    truth, into new tensors; every clean shard
    keeps its very tensors, so its slots' bits cannot move.  ``buffers``
    maps GLOBAL slot index -> ObsBuffer.  Returns ``(state,
    nbytes_uploaded)``."""
    _, n = mesh_shards(mesh, axis)
    if state.n_shards != n:
        raise ValueError(f"state has {state.n_shards} shards, the mesh {n}")
    blk = int(slot_cap) // n
    fields = [list(f) for f in state]
    nbytes = 0
    for k in sorted(dirty_shards):
        lo = k * blk
        sub = {i - lo: buf for i, buf in buffers.items() if lo <= i < lo + blk}
        dev = state.values[k].device
        for f, a in enumerate(_host_stack(sub, blk, bucket, n_dims)):
            fields[f][k] = torch.tensor(a, device=dev)
            nbytes += a.nbytes
    return ShardedBatchState(*(tuple(f) for f in fields)), nbytes


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
                          avg_best_idx=2.0, shrink_coef=0.1, mesh=None, mesh_axis=None):
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

    ``mesh=`` (a 1-D study mesh inside this process, ``mesh_axis`` its
    axis) takes the state as a :class:`ShardedBatchState` and runs this
    step, unsharded, over every shard's block of slots in shard order;
    the suggestion columns come back joined.  The slot
    count must divide by the shard count (:func:`slot_capacity`
    ``shards=`` sees to it).
    """
    if mesh is not None:
        return _sharded_step(ps, mesh, mesh_axis, dict(
            algo=algo, n_cand=n_cand, gamma=gamma, lf=lf, prior_weight=prior_weight,
            n_cand_cat=n_cand_cat, above_cap=above_cap, avg_best_idx=avg_best_idx,
            shrink_coef=shrink_coef))
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


def _sharded_step(ps, mesh, mesh_axis, kw):
    mesh_shards(mesh, mesh_axis, ps.device)
    fn = build_batched_step_fn(ps, **kw)

    def step(keys, values, active, losses, valid, vcol, acol, loss, idx, apply, warm,
             batch):
        outs = [fn(k, *st, *rows, w, batch) for st, (k, *rows, w) in _blocks(
            (values, active, losses, valid), (keys, vcol, acol, loss, idx, apply, warm))]
        return tuple(tuple(o[f] for o in outs) for f in range(4)) + tuple(
            torch.cat([o[f] for o in outs]) for f in (4, 5))

    return step


def _finite_check(values, active, losses, valid, new_v):
    new_v = torch.as_tensor(new_v, device=values.device)
    v_ok = torch.isfinite(torch.where(active, values, 0.0)).flatten(1).all(dim=1)
    l_ok = torch.isfinite(torch.where(valid, losses, 0.0)).all(dim=1)
    s_ok = torch.isfinite(new_v).flatten(1).all(dim=1)
    return ~(v_ok & l_ok & s_ok)


def _blocks(state_fields, per_slot):
    """Per shard, in shard order: its state tensors, and its block of each
    per-slot row array (host arrays or tensors, cut along the slot
    axis)."""
    n = len(state_fields[0])
    blk = len(per_slot[0]) // n
    return [(tuple(f[k] for f in state_fields),
             tuple(a[k * blk:(k + 1) * blk] for a in per_slot)) for k in range(n)]


def _sharded_finite_check(values, active, losses, valid, new_v):
    return torch.cat([_finite_check(*st, v)
                      for st, (v,) in _blocks((values, active, losses, valid), (new_v,))])


def _sharded_delta(values, active, losses, valid, vcol, acol, loss, idx, apply):
    for st, rows in _blocks((values, active, losses, valid), (vcol, acol, loss, idx, apply)):
        K.apply_delta_stacked(*st, *rows)
    return ShardedBatchState(values, active, losses, valid)


def build_finite_check_fn(mesh=None, mesh_axis=None):
    """The poisoned-slot detector: ``fn(values, active, losses, valid,
    new_v) -> poisoned [S] bool``.  A slot is poisoned when any active
    history value, any valid loss, or any of this round's suggestion
    columns (``new_v``, a host array or a tensor) is non-finite; masked
    positions (inactive dims, empty history slots) are exempt, so a freed
    slot's garbage never trips a healthy tenant.  Read-only.  ``mesh=``
    checks every shard's block on its own (the verdicts come back
    joined)."""
    if mesh is not None:
        mesh_shards(mesh, mesh_axis)
        return _sharded_finite_check
    return _finite_check


def build_batched_delta_fn(mesh=None, mesh_axis=None):
    """The stacked twin of the O(D) delta tell: ``fn(values, active,
    losses, valid, vcol, acol, loss, idx, apply)`` writes at most one
    staged delta per slot, each at its own index, in one gather/scatter
    per state tensor (in place) -- the backlog drain for a study that
    told more than once between asks.  ``mesh=`` writes every shard's
    block in place."""
    if mesh is not None:
        mesh_shards(mesh, mesh_axis)
        return _sharded_delta
    return K.apply_delta_stacked


# ---------------------------------------------------------------------------
# Program registrations (hyperopt-tpu-torch-lint --ir): the batched programs
# ---------------------------------------------------------------------------

from ..ops.compile import ProgramCapture, register_program  # noqa: E402

#: the shard count of the registry's study-axis programs
REGISTRY_SHARDS = 2


def _step_args(p):
    return ((p.keys_spec(),) + p.study_history_specs() + p.study_delta_specs()
            + (p.study_mask_spec(),))


@register_program(
    "serve.batched_step",
    families=("hyperopt_tpu_torch.serve.batched:build_batched_step_fn",),
)
def _registry_serve_step(p):
    """The service's one launch sequence per round: every slot's staged
    tell applied and every slot's ask drawn over the study axis, the
    stacked state written in place."""
    return ProgramCapture(
        fn=build_batched_step_fn(p.space, algo="tpe", n_cand=16),
        args=_step_args(p), kwargs={"batch": 1}, mutates=(1, 2, 3, 4),
        # stacked forms of closures whose GL402 behavior their solo
        # registrations pin (tpe.suggest, compile.sample_prior,
        # serve.batched_apply_delta)
        x64_check=False,
    )


@register_program(
    "serve.batched_anneal_step",
    families=("hyperopt_tpu_torch.serve.batched:build_batched_step_fn",),
)
def _registry_serve_anneal_step(p):
    """The annealing twin of ``serve.batched_step``."""
    return ProgramCapture(
        fn=build_batched_step_fn(p.space, algo="anneal"),
        args=_step_args(p), kwargs={"batch": 1}, mutates=(1, 2, 3, 4),
        # pinned by anneal.suggest, compile.sample_prior and
        # serve.batched_apply_delta
        x64_check=False,
    )


@register_program(
    "serve.batched_apply_delta",
    families=("hyperopt_tpu_torch.serve.batched:build_batched_delta_fn",
              "hyperopt_tpu_torch.ops.kernels:apply_delta_stacked"),
)
def _registry_serve_delta(p):
    """The backlog drain: one masked O(D) delta per slot, the stacked
    state written in place (the stacked ``torch_trials.apply_delta``)."""
    return ProgramCapture(fn=build_batched_delta_fn(),
                          args=p.study_history_specs() + p.study_delta_specs(),
                          mutates=(0, 1, 2, 3))


def _shard_state(fields):
    """Four stacked state tensors cut into :data:`REGISTRY_SHARDS` blocks
    of slots (the :class:`ShardedBatchState` layout)."""
    blk = fields[0].shape[0] // REGISTRY_SHARDS
    return tuple(tuple(f[k * blk:(k + 1) * blk].clone() for k in range(REGISTRY_SHARDS))
                 for f in fields)


def _registry_mesh():
    from ..parallel.mesh import STUDY_AXIS, virtual_mesh

    return virtual_mesh(REGISTRY_SHARDS, STUDY_AXIS), STUDY_AXIS


@register_program(
    "serve.batched_step_mesh",
    families=("hyperopt_tpu_torch.serve.batched:build_batched_step_fn",
              "hyperopt_tpu_torch.serve.batched:_sharded_step"),
)
def _registry_serve_step_mesh(p):
    """``serve.batched_step`` over the study axis cut into in-process
    shards (``mesh=virtual_mesh(2, "study")``): every shard's block of
    slots stepped in shard order, its state written in place."""
    mesh, axis = _registry_mesh()
    args = _step_args(p)
    return ProgramCapture(
        fn=build_batched_step_fn(p.space, algo="tpe", n_cand=16, mesh=mesh, mesh_axis=axis),
        args=args[:1] + _shard_state(args[1:5]) + args[5:], kwargs={"batch": 1},
        mutates=(1, 2, 3, 4), x64_check=False,
    )


@register_program(
    "serve.batched_delta_mesh",
    families=("hyperopt_tpu_torch.serve.batched:build_batched_delta_fn",
              "hyperopt_tpu_torch.serve.batched:_sharded_delta"),
)
def _registry_serve_delta_mesh(p):
    """The sharded backlog drain: one masked O(D) delta per slot, every
    shard's block written in place."""
    mesh, axis = _registry_mesh()
    return ProgramCapture(
        fn=build_batched_delta_fn(mesh=mesh, mesh_axis=axis),
        args=_shard_state(p.study_history_specs()) + p.study_delta_specs(),
        mutates=(0, 1, 2, 3),
    )


@register_program(
    "serve.guard_finite_check",
    families=("hyperopt_tpu_torch.serve.batched:build_finite_check_fn",
              "hyperopt_tpu_torch.serve.batched:_finite_check"),
)
def _registry_guard_finite_check(p):
    """The poisoned-slot detector: one masked finiteness reduction over
    the stacked state and the round's suggestion columns, ``[S]`` bool
    out, read-only."""
    new_v = torch.zeros((p.n_studies, p.space.n_dims, 1), dtype=torch.float32,
                        device=p.device)
    return ProgramCapture(fn=build_finite_check_fn(),
                          args=p.study_history_specs() + (new_v,))
