"""Population-Based Training on the card: ``compile_pbt``.

The counterpart of :mod:`hyperopt_tpu.pbt`.  A population of P members
trains in lockstep; every ``exploit_every`` steps the bottom quantile
copies the parameters of the rank-matched top member (exploit) and
perturbs its hyperparameters by a log-uniform factor (explore).  Where
the reference scans the whole schedule in one XLA program, here one
round -- ``exploit_every`` steps of the user's ``train_fn`` and the
exploit/explore event -- is captured once into a ``torch.cuda.CUDAGraph``
and replayed ``n_rounds`` times over static tensors; on the CPU the same
round runs eagerly.

``shard_mode="shard_map"`` with a 1-D ``trial`` mesh inside this process
(:func:`~hyperopt_tpu_torch.parallel.mesh.virtual_mesh`) splits the
population into per-shard member blocks on the caller's device: every
block trains its ``exploit_every`` steps on its own, and each exploit
gathers twice -- the losses, and the member states -- into static
tensors, where the reference all-gathers over its mesh.  The unsharded
schedule is the same round over one block, which is the population
itself and needs no gather.  PyTorch has no GSPMD, so ``"constraint"``
(the default with a mesh, as in the reference) runs the same per-block
program.

Contract: ``train_fn(state, hypers, key) -> (state, losses [P])`` is one
training step of the whole population (``state`` a pytree of dicts,
lists and tuples of tensors with the population on the leading axis,
``hypers`` a dict of ``[P]`` tensors, ``key`` a port key ``[2]``).  On the
card it must be capturable: no host reads, no host-to-device copies.

    from hyperopt_tpu_torch.pbt import compile_pbt

    runner = compile_pbt(train_fn, init_state, {"lr": (1e-4, 1.0)},
                         pop_size=8, exploit_every=5, n_rounds=20)
    out = runner(seed=0)
    out["best_loss"], out["hypers"], out["loss_history"]  # [rounds, P]
"""

from __future__ import annotations

import numpy as np
import torch

from . import random as R
from .utils import capture_graph, host_copy, resolve_device, tree_leaves, tree_map
from .utils.population import copy_into, hypers_dict, log_bounds, log_uniform_start, to_device

__all__ = ["compile_pbt"]


def _perturb_factors(key, shape, lo, hi):
    """``jax.random.uniform(key, shape, minval=lo, maxval=hi)`` as XLA
    compiles it inside the schedule: the scale and shift contract into
    one FMA."""
    floats = (R.random_bits(key, shape) >> 9).to(torch.float32) * 2.0**-23
    lo_t = R._const(float(lo), key.device)
    hi_t = R._const(float(hi), key.device)
    return torch.maximum(lo_t, R._fma(floats, hi_t - lo_t, lo_t))


def _stable_order(losses):
    """``jnp.argsort``'s order: ascending, stable, NaN last."""
    return torch.argsort(losses, stable=True)


def _resolve_shard_mode(shard_mode, mesh):
    """The population-sharding regime: None keeps the default (the
    reference's GSPMD constraints when a mesh is given, here the same
    per-block program as ``"shard_map"``); ``"shard_map"`` trains
    per-shard member blocks that meet only at exploit (or rung)
    boundaries."""
    if shard_mode is None:
        return "constraint" if mesh is not None else None
    mode = str(shard_mode)
    if mode not in ("constraint", "shard_map"):
        raise ValueError(f"shard_mode={shard_mode!r}; expected 'constraint' or 'shard_map'")
    if mesh is None:
        raise ValueError(f"shard_mode={mode!r} requires mesh=")
    return mode


def _check_divisible(pop, mesh, trial_axis, what):
    n_dev = int(mesh.shape[trial_axis])
    if pop % n_dev:
        raise ValueError(
            f"{what}={pop} must divide by the {trial_axis!r} mesh axis size {n_dev} for "
            "shard_map population sharding"
        )
    return n_dev


def _place_population(state, n, device):
    """The population pytree cut into ``n`` equal member blocks along its
    leading axis, each in new memory on ``device``."""
    full = to_device(state, device)
    return [tree_map(lambda x, k=k: x[k * (x.shape[0] // n):(k + 1) * (x.shape[0] // n)].clone(),
                     full) for k in range(n)]


def _train_blocks(train_fn, blocks, hypers, keys):
    """One step of ``train_fn`` per row of ``keys`` on each member block in
    turn, with its slice of ``hypers`` (``{name: [P]}``): the trained
    blocks and each block's last losses (float32)."""
    trained, losses_out, lo = [], [], 0
    for blk in blocks:
        n = tree_leaves(blk)[0].shape[0]
        hyp = {name: v[lo:lo + n] for name, v in hypers.items()}
        st = blk
        for key in keys:
            st, losses = train_fn(st, hyp, key)
        trained.append(st)
        losses_out.append(losses.to(torch.float32))
        lo += n
    return trained, losses_out


def _gather(dst, blocks):
    """The member ``blocks`` (pytrees or tensors, in shard order) joined
    along the leading axis: a lone block as it is, else copied block by
    block into the static ``dst`` -- the in-process twin of the
    reference's tiled ``all_gather``."""
    if len(blocks) == 1:
        return blocks[0]
    lo = 0
    for blk in blocks:
        n = tree_leaves(blk)[0].shape[0]
        tree_map(lambda d, b, lo=lo: d[lo:lo + n].copy_(b), dst, blk)
        lo += n
    return dst


def _scatter(blocks, full):
    """Copy the population pytree ``full`` into the member ``blocks``,
    block by block; a lone block that is ``full`` itself takes no copy."""
    if len(blocks) == 1 and blocks[0] is full:
        return
    lo = 0
    for blk in blocks:
        n = tree_leaves(blk)[0].shape[0]
        copy_into(blk, tree_map(lambda x, lo=lo: x[lo:lo + n], full))
        lo += n


def compile_pbt(
    train_fn,
    init_state,
    hyper_bounds,
    pop_size,
    exploit_every=5,
    n_rounds=20,
    exploit_quantile=0.25,
    perturb_factors=(0.8, 1.25),
    mesh=None,
    trial_axis="trial",
    shard_mode=None,
    device=None,
):
    """Compile a PBT schedule into a reusable runner on ``device`` (None =
    the card; ``"cpu"`` runs the same rounds eagerly).

    The arguments are the reference's (:func:`hyperopt_tpu.pbt.
    compile_pbt`): ``init_state`` the population pytree (leading axis P),
    ``hyper_bounds`` ``{name: (low, high)}`` sampled log-uniformly at the
    start and perturbed in log space, ``pop_size`` P, ``exploit_every``
    steps per round, ``n_rounds`` rounds, ``exploit_quantile`` the share
    replaced each round, ``perturb_factors`` the explore range.

    ``mesh`` (a 1-D mesh along ``trial_axis`` inside this process) with
    ``shard_mode="shard_map"`` or ``"constraint"`` (the default with a
    mesh; the same program here) splits the population into equal member
    blocks: ``train_fn`` receives one block (``P / n_shards`` leading
    axis) and its hypers, and the blocks meet only at each exploit, in one
    loss gather and one member-state gather.  ``pop_size`` must divide by
    the shard count.  For a ``train_fn`` whose per-member math does not
    depend on the member's place in the batch the schedule is bitwise the
    unsharded one.

    Returns ``runner(seed=0, init=None) -> dict`` with ``best_loss``,
    ``best_index``, ``best_hypers``, ``hypers`` (``{name: [P]}``, host
    numpy), ``loss_history`` ``[n_rounds, P]``, ``state`` (the final
    population, tensors on ``device``) and ``n_steps``;
    ``runner(init=prev_out)`` resumes a previous result's population for
    another ``n_rounds``.
    """
    P = int(pop_size)
    mode = _resolve_shard_mode(shard_mode, mesh)
    if mode is not None:
        from .parallel.mesh import in_process_shards

        _check_divisible(P, mesh, trial_axis, "pop_size")
    dev = resolve_device(device)
    n_shards = 1 if mode is None else in_process_shards(mesh, trial_axis, "compile_pbt", dev)
    names, log_lo, log_hi = log_bounds(hyper_bounds, dev)
    H = len(names)
    n_replace = max(1, int(round(P * float(exploit_quantile))))
    if 2 * n_replace > P:
        raise ValueError(
            f"exploit_quantile={exploit_quantile} replaces {n_replace} of {P} members; top "
            "and bottom quantiles must not overlap"
        )
    log_pf = (float(np.log(perturb_factors[0])), float(np.log(perturb_factors[1])))
    n_rounds = int(n_rounds)
    exploit_every = int(exploit_every)

    # the schedule's static tensors: the population, its hypers, the round
    # keys, the round counter and the loss history; one round reads and
    # writes them in place, so one captured graph serves every round
    state = to_device(init_state, dev)
    log_h = torch.zeros((P, H), dtype=torch.float32, device=dev)
    round_keys = torch.zeros((n_rounds, 2), dtype=torch.int64, device=dev)
    r = torch.zeros((), dtype=torch.int64, device=dev)
    loss_hist = torch.zeros((n_rounds, P), dtype=torch.float32, device=dev)
    members = torch.arange(P, dtype=torch.int64, device=dev)
    graph = []  # the captured round, on the card
    # the member blocks: the population itself on one shard, else equal
    # blocks whose states and losses each exploit gathers into ``state``
    # and ``g_losses``
    blocks, g_losses = [state], None
    if n_shards > 1:
        blocks = _place_population(init_state, n_shards, dev)
        g_losses = torch.zeros((P,), dtype=torch.float32, device=dev)

    def one_round():
        """``exploit_every`` train steps of every member block, then one
        exploit/explore event over the gathered population."""
        key = round_keys.index_select(0, r.reshape(1))[0]
        k_steps, k_perturb = R.split(key).unbind(0)
        trained, blk_losses = _train_blocks(train_fn, blocks, hypers_dict(log_h, names),
                                            R.split(k_steps, exploit_every))
        losses = _gather(g_losses, blk_losses)  # rank on the window's last step
        st = _gather(state, trained)
        # exploit: bottom member i copies the rank-matched top member;
        # explore: its copied hypers move by a log-uniform factor, clipped
        order = _stable_order(losses)
        top = order[:n_replace]
        bottom = order[P - n_replace:]
        src = members.index_copy(0, bottom, top)  # identity elsewhere
        _scatter(blocks, tree_map(lambda x: x.index_select(0, src), st))
        factors = _perturb_factors(k_perturb, (n_replace, H), log_pf[0], log_pf[1])
        new_rows = torch.minimum(torch.maximum(log_h.index_select(0, top) + factors, log_lo),
                                 log_hi)
        log_h.index_copy_(0, bottom, new_rows)
        loss_hist.index_copy_(0, r.reshape(1), losses[None])
        r.add_(1)

    def _run(seed, init, eager):
        replay = dev.type == "cuda" and not eager
        if replay and not graph:
            # the warm-up writes the static tensors; they are filled below
            graph.append(capture_graph(one_round, dev))
        if init is None:
            base = R.key(int(seed) % 2**32, device=dev)
            k_init, k_rounds = R.split(base).unbind(0)
            _scatter(blocks, to_device(init_state, dev))
            log_h.copy_(log_uniform_start(k_init, (P, H), log_lo, log_hi))
        else:
            missing = [n for n in names if n not in init["hypers"]]
            if missing:
                raise ValueError(f"init hypers missing {missing}; expected {names}")
            bad = {n: np.shape(init["hypers"][n]) for n in names
                   if np.shape(init["hypers"][n]) != (P,)}
            if bad:
                raise ValueError(
                    f"init hypers must cover {P} members x {names}; got shapes {bad}")
            # a resume marker folded in: the resumed rounds do not replay
            # the first segment's perturbation keys
            base = R.fold_in(R.key(int(seed) % 2**32, device=dev), 1)
            _, k_rounds = R.split(base).unbind(0)
            _scatter(blocks, to_device(init["state"], dev))
            h0 = np.stack([np.asarray(init["hypers"][n], np.float32) for n in names], axis=1)
            # XLA's log, so a resumed population starts from the reference's bits
            log_h.copy_(R._log(torch.from_numpy(h0).to(dev)))
        round_keys.copy_(R.split(k_rounds, n_rounds))
        r.zero_()
        for _ in range(n_rounds):
            if replay:
                graph[0].replay()
            else:
                one_round()
        return _package()

    def _package():
        loss_np = host_copy(loss_hist)
        log_h_np = host_copy(log_h)
        final = loss_np[-1]
        # NaN-safe: a member perturbed into divergence in the last round
        # must not win
        bi = int(np.argmin(np.where(np.isfinite(final), final, np.inf)))
        hypers = {n: np.exp(log_h_np[:, i]) for i, n in enumerate(names)}
        return {
            "best_loss": float(loss_np[-1, bi]),
            "best_index": bi,
            "best_hypers": {n: float(v[bi]) for n, v in hypers.items()},
            "hypers": hypers,
            "log_hypers": log_h_np,
            "loss_history": loss_np,
            "state": tree_map(lambda *xs: torch.cat(xs), *blocks),
            "n_steps": int(n_rounds * exploit_every),
        }

    def runner(seed=0, init=None):
        """``init=prev_out`` resumes: the population state and hypers of a
        previous result dict (or one rebuilt through
        :func:`hyperopt_tpu_torch.utils.checkpoint.load_pytree`) train for
        another ``n_rounds``."""
        return _run(seed, init, eager=False)

    # the same schedule with every round run eagerly (the card's captured
    # rounds are held against it), the captured round's graph, and the
    # round itself with its counter
    runner._run = _run
    runner._graph = graph
    runner._round, runner._round_index = one_round, r
    runner._shard_mode = mode
    return runner
