"""The whole optimization loop on the card: ``compile_fmin``, each step a
CUDA-graph replay.

The counterpart of :mod:`hyperopt_tpu.device_loop`, where the ask,
evaluate and tell of every trial compile into one XLA program (a
``lax.scan`` over the history carry).  Here one step -- the key fold, the
suggestion (TPE, annealing, random or adaptive TPE), the user's objective
over the batch and the history append -- is captured once into a
``torch.cuda.CUDAGraph`` and replayed once per step:

* the carry (``values [D, cap]``, ``active``, ``losses``, ``valid``, with
  ``cap = round_up(W + N, 128)``) lives in static tensors that the step
  writes in place at ``c0 + i*B + arange(B)``;
* the step index ``i`` is a device counter the step itself advances, and
  the base key a static tensor filled before the first replay; the step's
  key is ``fold_in(fold_in(key(seed), c0), i)``, as the reference folds;
* the reference's ``lax.cond`` between the prior draw and the model
  needs no device read: every written slot is valid, failed or not, so
  the history count at step ``i`` is ``c0 + i*B``.  One graph is captured
  per regime and the host picks which to replay;
* the early-stop rules (``loss_threshold``, ``no_progress_steps``) keep
  ``stop``/``best``/``stale``/``n_done`` on the card; a stopped step
  writes nothing, so the result is the reference's ``while_loop``'s, and
  the host reads the one-byte flag every :data:`STOP_POLL` replays;
* chunk boundaries (``chunk_size``) read :func:`~hyperopt_tpu_torch.ops.
  kernels.history_summary` for the progress row (where the reference
  calls ``io_callback``), publish the carry as a durable bundle and host
  the crash points; a padded tail chunk's steps are simply not replayed.

A seed sweep (``runner(seed=[...])``) captures the same step over a
leading seed axis -- the study axis of the TPE and annealing bodies and
of the prior draw -- so every seed's stream is bitwise its solo run.  On
the CPU the same step function runs eagerly; on the card there is no
eager path in the public API, and a failed capture raises.

``mesh=`` (a :class:`~hyperopt_tpu_torch.parallel.mesh.RankMesh` inside
this process, :func:`~hyperopt_tpu_torch.parallel.mesh.virtual_mesh`)
shards the step as the reference's mesh does, every shard on the one
device and inside the one captured graph: ``cand_axis`` splits the EI
candidate sweep over its ranks
(:func:`~hyperopt_tpu_torch.parallel.sharded.build_sharded_suggest_fn`,
each rank's sweep in turn, then the argmax over ranks).  ``trial_axis``
is a placement axis inside one process: it is checked as the reference
checks it, and, where every block would share the one device and the
one graph, the batch runs as the unsharded body.  Over real ranks, one
process each, rank ``r`` evaluates block ``r`` of the batch: every rank
runs the same suggestion (the same key and history give the same
batch), evaluates its ``B / n`` columns (the first graph), the host
gathers the ``[B]`` losses in one ``all_gather``, and every rank writes
the same history (the second graph).

With ``asha=`` one step is one ASHA bracket: B fresh configs, then the
unrolled ladder of :func:`~hyperopt_tpu_torch.hyperband.rung_schedule`
-- each rung trains its survivors through the
:class:`TrainableObjective`'s ``step_fn``, writes their losses and the
rung record ``rung_of`` in place, ranks them with
:func:`~hyperopt_tpu_torch.hyperband.rung_rank` and gathers the best
``1/eta`` into the next rung's narrower width -- still one graph per
regime, since every width inside a bracket is static.  With
``artifact_callback`` the bracket also writes its full-fidelity winner
(slot, loss, trained state) into a per-chunk static buffer that the host
reads at the chunk boundary.

``fn`` is a batch objective over a dict of ``[B]`` value tensors
(natural space; categorical dims as float indices), optionally taking
the ``active`` masks by keyword, returning ``[B]`` losses; or a
:class:`TrainableObjective`.  Non-finite losses are masked out of the
posterior.
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import torch

from . import random as R
from .exceptions import AllTrialsFailed, CheckpointError
from .ops import gmm_scores as G
from .ops.compile import PackedSpace, compile_space
from .ops.kernels import HistoryState, history_summary
from .utils import capture_graph, host_copy, tree_map

__all__ = [
    "STOP_POLL",
    "TrainableObjective",
    "compile_fmin",
    "fmin_on_device",
    "history_from_trials",
]

#: replays between two host reads of the early-stop flag: a stopped
#: step is a no-op, so polling late costs at most this many idle steps
STOP_POLL = 16

# the tag folded into a step key for the trainable objective's keys, so
# the suggestion stream is untouched (the reference's ``0x7EA1``)
_TRAIN_TAG = 0x7EA1


class TrainableObjective:
    """A stateful objective: per-trial training inside the compiled step.

    Three per-trial functions, mapped over the trial batch with
    ``torch.func.vmap`` by :func:`compile_fmin`:

    * ``init_fn(key, cfg) -> state`` -- one trial's carried state (a
      pytree of tensors: params, optimizer moments) from its key
      (``[2]``, see :mod:`hyperopt_tpu_torch.random`) and its
      hyperparameters (0-dim tensors, natural space; categorical dims as
      float indices; inactive dims 0.0).  It may take the ``active``
      masks by keyword.
    * ``step_fn(state, cfg, epoch) -> state`` -- one training epoch, run
      ``n_epochs`` times (a Python loop inside the captured step);
      gradients come from ``torch.func.grad``.
    * ``loss_fn(state, cfg) -> scalar`` -- the trial's reported loss.

    Trial keys are ``split(fold_in(step_key, 0x7EA1), B)``: the
    suggestion stream is the one a plain objective with the same seed
    sees.
    """

    def __init__(self, init_fn, step_fn, loss_fn, n_epochs=1):
        if int(n_epochs) < 1:
            raise ValueError("n_epochs must be a positive integer")
        self.init_fn = init_fn
        self.step_fn = step_fn
        self.loss_fn = loss_fn
        self.n_epochs = int(n_epochs)

    def __repr__(self):
        return f"TrainableObjective(n_epochs={self.n_epochs})"


def history_from_trials(space, trials):
    """A host ``Trials`` store as a ``runner(init=...)`` dict: only
    completed, status-ok, finite-loss trials, in tid order, through the
    suggest paths' :class:`~hyperopt_tpu_torch.torch_trials.ObsBuffer`.
    ``space`` is an ``hp.*`` space or a PackedSpace."""
    from .torch_trials import ObsBuffer

    ps = space if isinstance(space, PackedSpace) else compile_space(space, device="cpu")
    buf = ObsBuffer(ps)
    buf.sync(trials)
    n = buf.count
    return {
        "values": buf.values[:, :n].copy(),
        "active": buf.active[:, :n].copy(),
        "losses": buf.losses[:n].copy(),
    }


def _round_up(n, m):
    return (n + m - 1) // m * m


def _mesh_layout(mesh, trial_axis, cand_axis, algo, joint_ei, B, asha):
    """The reference's checks of ``mesh``/``trial_axis``/``cand_axis``,
    with its messages; returns whether the trial axis is in use."""
    if cand_axis is not None and mesh is None:
        raise ValueError("cand_axis requires a mesh")
    if mesh is None:
        return False
    from .parallel.mesh import RankMesh

    if not isinstance(mesh, RankMesh):
        raise TypeError(
            f"mesh= takes a parallel.mesh.RankMesh (virtual_mesh, mesh_from_spec); got "
            f"{type(mesh).__name__}")
    if cand_axis is not None:
        if cand_axis not in mesh.shape:
            raise ValueError(
                f"cand_axis {cand_axis!r} is not an axis of the mesh (axes: {tuple(mesh.shape)})")
        if algo not in ("tpe", "atpe"):
            raise ValueError(
                "cand_axis shards the (adaptive) TPE candidate sweep; "
                f"algo={algo!r} has no candidate sweep to shard")
        if joint_ei:
            raise ValueError(
                "cand_axis supports only the factorized EI argmax (joint_ei scores whole "
                "configurations on one device)")
    if cand_axis is not None and B == 1:
        # a 1-wide batch cannot shard: the cand axis carries the mesh
        return False
    if trial_axis is None:
        if cand_axis is None:
            raise ValueError("mesh given with trial_axis=None and no cand_axis: nothing to shard")
        return False
    if trial_axis not in mesh.shape:
        # a typo must never silently unshard the batch
        raise ValueError(
            f"trial_axis {trial_axis!r} is not an axis of the mesh (axes: "
            f"{tuple(mesh.shape)}); pass trial_axis=None to opt out of population sharding")
    n = int(mesh.shape[trial_axis])
    # asha= trains each rung over a gcd-sized sub-mesh, so shrinking rung
    # widths need not divide the axis
    if B % n and asha is None:
        raise ValueError(f"batch_size={B} must be a multiple of mesh axis {trial_axis!r} size {n}")
    return True


def _is_seed_list(seed):
    return isinstance(seed, (list, tuple)) or (isinstance(seed, np.ndarray) and seed.ndim > 0)


class _Program:
    """The compiled loop's carry in static tensors and its step: eager
    (:meth:`step`) or one graph replay per step on the card (:meth:`run`).

    ``n_seeds`` None runs one experiment; an int ``S`` runs S in lockstep
    over a leading seed axis.  ``launches_per_replay`` counts the
    ``gmm_llr`` launches captured in each regime's graph (the kernel's
    wrapper counts at capture, not at replay); ``replays`` counts the
    replays of the current run, per regime.  Over real ranks (the
    ``trial`` axis across processes) a step is two graphs, the regime's
    :meth:`ask` and the one :meth:`tell`, with the host gather between
    them: ``replays`` counts steps, each two graph replays and one
    ``all_gather``."""

    def __init__(self, loop, n_seeds):
        self.loop = loop
        lp = loop
        dev = lp.ps.device
        lead = () if n_seeds is None else (int(n_seeds),)
        self.lead = lead
        self.values = torch.zeros(lead + (lp.D, lp.cap), dtype=torch.float32, device=dev)
        self.active = torch.zeros(lead + (lp.D, lp.cap), dtype=torch.bool, device=dev)
        self.losses = torch.zeros(lead + (lp.cap,), dtype=torch.float32, device=dev)
        self.valid = torch.zeros(lead + (lp.cap,), dtype=torch.bool, device=dev)
        self.base_key = torch.zeros(lead + (2,), dtype=torch.int64, device=dev)
        self.c0 = torch.zeros((), dtype=torch.int64, device=dev)
        self.i = torch.zeros((), dtype=torch.int64, device=dev)
        self.slots = torch.arange(lp.B, dtype=torch.int64, device=dev)
        if lp.early:
            self.stop = torch.zeros(lead, dtype=torch.bool, device=dev)
            self.best = torch.full(lead, math.inf, dtype=torch.float32, device=dev)
            self.stale = torch.zeros(lead, dtype=torch.int64, device=dev)
            self.n_done = torch.zeros(lead, dtype=torch.int64, device=dev)
        if lp.ranks is not None:
            # the step's suggestions, this rank's block losses and the
            # gathered losses, between the two graphs of a rank's step
            self.pend_v = torch.zeros(lead + (lp.D, lp.B), dtype=torch.float32, device=dev)
            self.pend_a = torch.zeros(lead + (lp.D, lp.B), dtype=torch.bool, device=dev)
            self.blk_l = torch.zeros(lead + (lp.block[1],), dtype=torch.float32, device=dev)
            self.full_l = torch.zeros(lead + (lp.B,), dtype=torch.float32, device=dev)
        self.rung_of = self.win = None
        if lp.asha is not None:
            # the highest rung each slot reached; -1: warm or untouched
            self.rung_of = torch.full((lp.cap,), -1, dtype=torch.int32, device=dev)
            if lp.asha.collect:
                self.win = lp.asha.winner_buffers(dev)
        self.graphs, self.tell_graph = {}, None
        self.launches_per_replay = {}
        self.replays = {r: 0 for r in lp.regimes}
        if dev.type == "cuda":
            for regime in lp.regimes:
                self._capture(regime)
            if lp.ranks is not None:
                self.tell_graph = capture_graph(self.tell, self.values.device)

    def state(self):
        return HistoryState(self.values, self.active, self.losses, self.valid)

    def _evaluate(self, key, values, active, lo=0):
        """Losses ``[..., b]`` of one step's suggestions (``values [..., D,
        b]``, the batch's columns from ``lo`` on); a seed axis is evaluated
        seed by seed, so each seed's objective runs the same operations at
        the same shapes as its solo run."""
        lp = self.loop
        if not self.lead:
            return lp.evaluate(key, values, active, lo)
        return torch.stack([lp.evaluate(key[s], values[s], active[s], lo)
                            for s in range(self.lead[0])])

    def _suggest(self, regime, key):
        lp = self.loop
        if regime == "prior":
            return lp.ps.sample_prior_fn(key, lp.B)
        return lp.model(key, self.values, self.active, self.losses, self.valid, lp.B)

    def step(self, regime):
        """One step, eagerly: fold the key, draw ``B`` suggestions, evaluate
        them, write them into the carry, advance the counter (with
        ``asha=``: one bracket, :meth:`bracket`; over real ranks
        :meth:`ask`, :meth:`gather` and :meth:`tell`)."""
        lp = self.loop
        if lp.asha is not None:
            return self.bracket(regime)
        if lp.ranks is not None:
            self.ask(regime)
            self.gather()
            return self.tell()
        key = R.fold_in(R.fold_in(self.base_key, self.c0), self.i)
        new_v, new_a = self._suggest(regime, key)
        self._write(new_v, new_a, self._evaluate(key, new_v, new_a))

    def ask(self, regime):
        """Over real ranks, a step's first graph: every rank draws the same
        ``B`` suggestions and evaluates its own block of them."""
        key = R.fold_in(R.fold_in(self.base_key, self.c0), self.i)
        new_v, new_a = self._suggest(regime, key)
        lo, b = self.loop.block
        self.pend_v.copy_(new_v)
        self.pend_a.copy_(new_a)
        self.blk_l.copy_(self._evaluate(key, new_v[..., lo:lo + b], new_a[..., lo:lo + b], lo))

    def gather(self):
        """Over real ranks, on the host: every rank's block losses, one
        all_gather, joined in rank order along the batch."""
        from .parallel.multihost import fetch_global

        joined = fetch_global(self.blk_l.movedim(-1, 0), sharded=True, group=self.loop.ranks[2])
        self.full_l.copy_(torch.from_numpy(joined).movedim(0, -1))

    def tell(self):
        """Over real ranks, a step's second graph: every rank writes the
        same suggestions and gathered losses into its carry."""
        self._write(self.pend_v, self.pend_a, self.full_l)

    def _write(self, new_v, new_a, new_l):
        """Write one step's suggestions and losses at ``c0 + i*B +
        arange(B)`` (a stopped experiment writes nothing) and advance the
        counter."""
        lp = self.loop
        idx = self.c0 + self.i * lp.B + self.slots
        if lp.early:
            go = ~self.stop
            batch_best = torch.amin(torch.where(torch.isfinite(new_l), new_l, math.inf), dim=-1)
            improved = batch_best < self.best
            best = torch.minimum(self.best, batch_best)
            # no_progress_loss parity: the stale count runs only once some
            # finite best exists
            stale = torch.where(improved | ~torch.isfinite(best), 0, self.stale + 1)
            stop = (best <= lp.thr) | (stale >= lp.stale_cap)
            g = go[..., None]
            new_v = torch.where(g[..., None], new_v, self.values.index_select(-1, idx))
            new_a = torch.where(g[..., None], new_a, self.active.index_select(-1, idx))
            new_l = torch.where(g, new_l, self.losses.index_select(-1, idx))
            self.valid.index_copy_(-1, idx, self.valid.index_select(-1, idx) | g)
            self.best.copy_(torch.where(go, best, self.best))
            self.stale.copy_(torch.where(go, stale, self.stale))
            self.stop.copy_(torch.where(go, stop, self.stop))
            self.n_done.add_(go.to(torch.int64))
        else:
            self.valid.index_fill_(-1, idx, True)
        self.values.index_copy_(-1, idx, new_v)
        self.active.index_copy_(-1, idx, new_a)
        self.losses.index_copy_(-1, idx, new_l)
        self.i.add_(1)

    def bracket(self, regime):
        """One ASHA bracket, eagerly: suggest ``B`` configs, give each its
        history slot, then the compacting rung ladder -- rung ``r`` trains
        its survivors, writes their losses and ``rung_of`` in place, and
        :func:`~hyperopt_tpu_torch.hyperband.rung_rank` keeps the best
        ``width/eta``, whose states, configs and slots are gathered to the
        next static width.  With an artifact buffer the full-fidelity
        winner's slot, loss and state land in row ``i % chunk_steps``."""
        from .hyperband import rung_rank

        lp = self.loop
        a = lp.asha
        key = R.fold_in(R.fold_in(self.base_key, self.c0), self.i)
        new_v, new_a = self._suggest(regime, key)
        states = a.init_states(R.split(R.fold_in(key, _TRAIN_TAG), lp.B), new_v, new_a)
        idx = self.c0 + self.i * lp.B + self.slots
        self.values.index_copy_(-1, idx, new_v)
        self.active.index_copy_(-1, idx, new_a)
        self.valid.index_fill_(-1, idx, True)
        slots, vals, act = idx, new_v, new_a
        for r, (width, _, _) in enumerate(a.ladder):
            states, losses = a.rung_train[r](states, vals, act)
            self.losses.index_copy_(-1, slots, losses)
            self.rung_of.index_fill_(-1, slots, r)
            order = rung_rank(losses, 1, width)[0]
            if r + 1 < len(a.ladder):
                keep = order[: a.ladder[r + 1][0]]
                states = tree_map(lambda x: x.index_select(0, keep), states)
                vals = vals.index_select(1, keep)
                act = act.index_select(1, keep)
                slots = slots.index_select(0, keep)
            elif self.win is not None:
                w = order[:1]
                row = (self.i % a.chunk_steps).reshape(1)
                self.win["slot"].index_copy_(0, row, slots.index_select(0, w).to(torch.int32))
                self.win["loss"].index_copy_(0, row, losses.index_select(0, w))
                tree_map(lambda dst, x: dst.index_copy_(0, row, x.index_select(0, w)),
                         self.win["params"], states)
        self.i.add_(1)

    def _capture(self, regime):
        """Warm the step up once on a side stream (the kernel's build, the
        launch-config cache, the cached constants), then capture it; the
        kernel's launches of the captured call are the replay's.  The
        warm-up writes the zero carry; :meth:`reset` refills it.  Over
        real ranks the captured step is :meth:`ask` (the host gather and
        the ``tell`` graph follow it at every replay)."""
        launches = []
        body = self.step if self.loop.ranks is None else self.ask

        def counted_step():
            before = G.KERNEL.launches
            body(regime)
            launches.append(G.KERNEL.launches - before)

        self.graphs[regime] = capture_graph(counted_step, self.values.device)
        self.launches_per_replay[regime] = launches[-1]

    def run(self, regime):
        """One step: a graph replay on the card (over real ranks two, with
        the host gather between them), the eager step on the CPU."""
        graph = self.graphs.get(regime)
        if graph is None:
            self.step(regime)
        elif self.loop.ranks is None:
            graph.replay()
        else:
            graph.replay()
            self.gather()
            self.tell_graph.replay()
        self.replays[regime] += 1

    def reset(self, seeds, state, c0, best0, start_step=0, rung_of=None):
        """Fill the carry for a run: ``seeds`` an int (or one per seed of
        the axis), ``state`` the four host arrays (None: empty), the warm
        offset ``c0``, the warm best ``best0`` (early stop), the first
        step index and, with ``asha=``, the rung record (None: all -1)."""
        lp = self.loop
        keys = [R.key(int(s) % (2**32)) for s in np.atleast_1d(seeds)]
        self.base_key.copy_(keys[0] if not self.lead else torch.stack(keys))
        if state is None:
            for t in self.state():
                t.zero_()
        else:
            for t, a in zip(self.state(), state):
                t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
        if self.rung_of is not None:
            if rung_of is None:
                self.rung_of.fill_(-1)
            else:
                self.rung_of.copy_(torch.from_numpy(np.ascontiguousarray(rung_of)))
        self.c0.fill_(int(c0))
        self.i.fill_(int(start_step))
        if lp.early:
            self.best.fill_(float(best0))
            self.stop.copy_(self.best <= lp.thr)
            self.stale.zero_()
            self.n_done.zero_()
        self.replays = {r: 0 for r in lp.regimes}

    def host_state(self):
        """The carry as host numpy, one copy per tensor (a copy on the CPU
        too: a result must not alias the carry the next run writes); with
        ``asha=`` the rung record follows the four."""
        ts = list(self.state()) + ([] if self.rung_of is None else [self.rung_of])
        return [host_copy(t) for t in ts]

    def summary(self):
        """The chunk boundary's progress row as tensors: (best finite loss,
        written slots); with ``asha=`` the best counts full-fidelity
        trials only (a rung-0 loss is not comparable to a survivor's)."""
        full = None if self.rung_of is None else self.rung_of == len(self.loop.asha.ladder) - 1
        return history_summary(self.state(), best_of=full)

    def stopped(self):
        """Whether every experiment of the program has stopped (one host
        read)."""
        return bool(self.stop.all())


class _Asha:
    """The bracket of ``compile_fmin(asha=...)``: the rung ladder, the
    vmapped per-trial init and one trainer per rung width, and (with an
    artifact stream) the winner buffers' geometry."""

    def __init__(self, eta, rung_epochs, ladder, init_states, rung_train, collect,
                 chunk_steps, n_dims):
        self.eta, self.rung_epochs = eta, rung_epochs
        self.n_dims = n_dims
        self.ladder = ladder
        self.init_states = init_states
        self.rung_train = rung_train
        self.collect = collect
        self.chunk_steps = chunk_steps

    def winner_buffers(self, device):
        """One row per bracket of a chunk: the full-fidelity winner's slot,
        loss and trained state (its template from one trial's init)."""
        D = self.n_dims
        one = self.init_states(R.split(R.key(0, device=device), 1),
                               torch.zeros((D, 1), dtype=torch.float32, device=device),
                               torch.ones((D, 1), dtype=torch.bool, device=device))
        n = self.chunk_steps
        return {
            "slot": torch.zeros((n,), dtype=torch.int32, device=device),
            "loss": torch.zeros((n,), dtype=torch.float32, device=device),
            "params": tree_map(lambda x: torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                                                     device=device), one),
        }

    def metadata(self):
        return {"eta": self.eta, "rung_epochs": self.rung_epochs,
                "n_rungs": len(self.ladder), "ladder": [tuple(row) for row in self.ladder]}


class _Loop:
    """What every program of one ``compile_fmin`` shares: the space, the
    geometry, the model step and the objective."""

    def __init__(self, ps, D, B, cap, n_startup_jobs, algo, model, evaluate, early, thr,
                 stale_cap, asha=None, ranks=None):
        self.ps, self.D, self.B, self.cap = ps, D, B, cap
        # over real ranks: (n, index, group) of the trial axis, and this
        # rank's block of the batch, (first column, width)
        self.ranks = ranks
        self.block = None if ranks is None else (ranks[1] * (B // ranks[0]), B // ranks[0])
        self.n_startup_jobs = n_startup_jobs
        self.algo = algo
        self.model = model
        self.evaluate = evaluate
        self.early = early
        self.thr = thr
        self.stale_cap = stale_cap
        self.asha = asha
        self.regimes = ("prior",) if algo == "rand" else ("prior", "model")

    def regime(self, step, c0):
        """The regime of global step ``step``: the prior while the history
        (every written slot, failed or not) is under ``n_startup_jobs``."""
        if self.algo == "rand" or c0 + step * self.B < self.n_startup_jobs:
            return "prior"
        return "model"


def compile_fmin(
    fn,
    space,
    max_evals,
    batch_size=1,
    algo="tpe",
    n_startup_jobs=20,
    n_EI_candidates=24,
    n_EI_candidates_cat=None,
    gamma=0.25,
    prior_weight=1.0,
    linear_forgetting=25,
    joint_ei=False,
    avg_best_idx=2.0,
    shrink_coef=0.1,
    mesh=None,
    trial_axis="trial",
    cand_axis=None,
    loss_threshold=None,
    no_progress_steps=None,
    warm_capacity=0,
    chunk_size=None,
    progress_callback=None,
    progress_every=1,
    checkpoint_path=None,
    checkpoint_every=1,
    resume=False,
    fs=None,
    metrics_registry=None,
    asha=None,
    artifact_callback=None,
    device=None,
):
    """Compile a whole HPO experiment into a reusable runner on ``device``
    (None = the card; ``"cpu"`` runs the same steps eagerly).

    Returns ``runner(seed=0, return_trials=False, init=None, resume=None)
    -> result dict``; ``runner(seed=[s0, s1, ...])`` runs a seed sweep in
    lockstep and returns one result per seed, each bitwise its solo run.
    The arguments are the reference's (:func:`hyperopt_tpu.device_loop.
    compile_fmin`): ``algo`` is ``'tpe'``, ``'anneal'``, ``'rand'`` or
    ``'atpe'`` at any ``batch_size``; ``loss_threshold`` and
    ``no_progress_steps`` stop early on the card; ``warm_capacity`` and
    ``runner(init=prev_out)`` continue an experiment; ``chunk_size`` with
    ``progress_callback``/``progress_every``,
    ``checkpoint_path``/``checkpoint_every``/``resume`` and ``fs`` (the
    crash-point seam of :mod:`hyperopt_tpu_torch.distributed.faults`)
    make every chunk boundary a progress, checkpoint and resume point,
    bitwise the flat run.  ``asha={"eta", "rung_epochs", "n_rungs"}``
    (a :class:`TrainableObjective` only) makes each step one ASHA bracket
    of ``batch_size`` configs (a power of ``eta``): rung ``r`` trains the
    survivors ``rung_epochs * eta**r`` further epochs, the ladder taking
    the place of ``n_epochs``; ``artifact_callback`` (with ``asha=`` and
    ``chunk_size``) receives one ``{"bracket", "slot", "loss",
    "params"}`` dict per bracket, the full-fidelity winner with its
    trained state as host numpy.  ``metrics_registry`` (a
    :class:`~hyperopt_tpu_torch.obs.MetricsRegistry`, with ``chunk_size``
    and no ``progress_callback``) lands each progress row on the
    registry (:func:`~hyperopt_tpu_torch.obs.device.progress_to_registry`).

    ``mesh`` (a :class:`~hyperopt_tpu_torch.parallel.mesh.RankMesh`;
    :func:`~hyperopt_tpu_torch.parallel.mesh.virtual_mesh` puts every rank
    in this process) shards each step, with the reference's checks and
    messages.  ``cand_axis`` (``algo='tpe'``/``'atpe'``, factorized EI)
    splits the EI candidate sweep over that axis's ranks: each rank draws
    ``ceil(n_EI_candidates / ranks)`` candidates from the step key folded
    by its position and scores them (one ``gmm_llr`` launch per rank per
    model step), and the argmax over the ranks' winners picks each dim's
    value -- the ranks' bodies and the reduction run in turn inside the
    one captured graph, with no host read.  The prior steps are
    untouched, so startup draws are the unsharded program's bits.
    ``trial_axis`` (when it names an axis of the mesh; at ``batch_size``
    1 with a ``cand_axis`` it is ignored) is a placement axis: its width
    must divide ``batch_size``, as in the reference, and with ``asha=``
    ``runner._asha_submesh_devices`` reports the reference's rung
    sub-mesh, ``gcd(smallest rung width, width)``.  Inside one process
    every block would share the one device and the one captured graph,
    so the batch and the rungs run as the unsharded body and the stream
    is the unsharded one, bit for bit (blocks on cards of their own are
    ROADMAP.md Queue A, item 15c, part 6).  On a 1-D ``trial`` mesh of
    real ranks (:func:`~hyperopt_tpu_torch.parallel.mesh.default_mesh`
    after :func:`~hyperopt_tpu_torch.parallel.multihost.initialize`) each
    rank evaluates its ``B / n`` columns of every step's batch: a step is
    two captured graphs (the suggestion and this rank's evaluation; the
    history write) with one host ``all_gather`` of the losses between
    them, since a ``gloo`` collective cannot sit inside a graph, and
    every rank ends with the same history.  On an objective whose
    per-trial math does not depend on its place in the batch the stream
    is bitwise the unsharded one.  A ``cand`` axis or ``asha=`` over
    processes is refused (``NotImplementedError``): their gathers would
    sit inside the sweep or the bracket.

    The result dict has ``best`` (``{label: value}``, the index form
    ``fmin`` returns), ``best_loss``, ``best_index``, ``losses [N]``,
    ``values [D, N]``, ``active [D, N]`` (the warm prefix included),
    ``n_evals``, ``n_total`` and, with ``return_trials=True``, a rebuilt
    host ``Trials`` store; with ``asha=`` also ``rung_of [N]`` (the
    highest rung each trial reached, -1 for warm slots) and the ``asha``
    ladder, and ``best`` ranks full-fidelity trials only.
    """
    if algo not in ("tpe", "anneal", "rand", "atpe"):
        raise ValueError(f"unknown algo {algo!r}: expected tpe|anneal|rand|atpe")
    if algo == "atpe" and joint_ei:
        raise ValueError(
            "algo='atpe' supports only the factorized EI argmax (the adaptive layer has "
            "no joint-scoring path); drop joint_ei or use algo='tpe'"
        )
    B = int(batch_size)
    if B < 1:
        raise ValueError("batch_size must be a positive integer")
    shard_trials = _mesh_layout(mesh, trial_axis, cand_axis, algo, joint_ei, B, asha)
    trainable = isinstance(fn, TrainableObjective)
    if asha is not None:
        if not isinstance(asha, dict):
            raise ValueError(
                'asha= takes a dict of rung options ({"eta", "rung_epochs", "n_rungs"})')
        unknown = set(asha) - {"eta", "rung_epochs", "n_rungs"}
        if unknown:
            raise ValueError(
                f"unknown asha option(s) {sorted(unknown)}; expected eta|rung_epochs|n_rungs")
        if not trainable:
            raise ValueError(
                "asha= fuses rung-based early stopping into the per-trial training loop; fn "
                "must be a TrainableObjective"
            )
        if loss_threshold is not None or no_progress_steps is not None:
            raise ValueError(
                "asha= does not compose with loss_threshold/no_progress_steps (rung promotion "
                "IS the early stopping); drop one"
            )
        if cand_axis is not None:
            raise ValueError(
                "asha= does not compose with cand_axis (bracket populations shard over "
                "trial_axis; there is no sequential candidate sweep to shard)"
            )
    if artifact_callback is not None:
        if asha is None:
            raise ValueError("artifact_callback streams rung-winner params; it requires asha=")
        if chunk_size is None:
            raise ValueError(
                "artifact_callback rides the chunked scan path; pass chunk_size= to enable it")
    from .fmin import _validate_stopping

    _validate_stopping(None, loss_threshold)
    if no_progress_steps is not None and (
        not isinstance(no_progress_steps, (int, np.integer)) or no_progress_steps < 1
    ):
        raise ValueError("no_progress_steps must be a positive integer")
    chunked = chunk_size is not None
    if metrics_registry is not None and progress_callback is None:
        # the progress rows land on the registry: the same chunked-path
        # requirement as a progress_callback
        from .obs.device import progress_to_registry

        progress_callback = progress_to_registry(metrics_registry)
    if not chunked and (progress_callback is not None or checkpoint_path is not None or resume):
        raise ValueError(
            "progress_callback/checkpoint_path/resume ride the chunked scan path; pass "
            "chunk_size= to enable it"
        )
    early = loss_threshold is not None or no_progress_steps is not None
    if chunked:
        if early:
            raise ValueError(
                "chunk_size does not compose with loss_threshold/no_progress_steps (the "
                "early-stop path is unchunked); drop one"
            )
        if int(chunk_size) < 1:
            raise ValueError("chunk_size must be a positive integer")
        if int(progress_every) < 1 or int(checkpoint_every) < 1:
            raise ValueError("progress_every/checkpoint_every must be positive")
        if resume and checkpoint_path is None:
            raise ValueError("resume=True needs checkpoint_path")

    ps = compile_space(space, device=device)
    D = ps.n_dims
    n_ranks = trial_ranks = None
    if mesh is not None:
        from .parallel.mesh import in_process_shards, over_processes, process_block

        what = "compile_fmin(mesh=...)"
        if over_processes(mesh):
            # over real ranks a step's blocks meet in a host gather between
            # two graphs; a gather inside the sweep or the bracket cannot
            if cand_axis is not None:
                raise NotImplementedError(
                    f"{what}: the {cand_axis!r} axis over {mesh.size} processes would gather "
                    "inside the candidate sweep, which a captured step cannot hold over gloo "
                    "(ROADMAP.md Queue A, item 15c, part 6)")
            if asha is not None:
                raise NotImplementedError(
                    f"{what}: asha= over {mesh.size} processes would gather inside the "
                    "bracket, which a captured step cannot hold over gloo (ROADMAP.md Queue "
                    "A, item 15c, part 6)")
            trial_ranks = process_block(mesh, trial_axis, what)
        else:
            # every shard inside this process, on ps.device
            if shard_trials:
                in_process_shards(mesh, trial_axis, what, ps.device, one_axis=False)
            if cand_axis is not None:
                n_ranks = in_process_shards(mesh, cand_axis, what, ps.device, one_axis=False)
    n_steps = -(-int(max_evals) // B)
    W = int(warm_capacity)
    cap = _round_up(W + n_steps * B, 128)
    n_cand = int(n_EI_candidates)
    n_cand_cat = None if n_EI_candidates_cat is None else int(n_EI_candidates_cat)
    lf_f = float(linear_forgetting)
    pw = float(prior_weight)

    if algo == "tpe" and cand_axis is not None:
        from .parallel.sharded import build_sharded_suggest_fn, per_device_count

        # n_EI_candidates is the TOTAL sweep width: each rank draws
        # ceil(total / ranks), so the executed total may exceed it by < ranks
        model = build_sharded_suggest_fn(
            ps, mesh, per_device_count(n_cand, n_ranks), float(gamma), lf_f, pw, axis=cand_axis,
            n_cand_cat_per_device=per_device_count(n_cand if n_cand_cat is None else n_cand_cat,
                                                   n_ranks))
    elif algo == "tpe":
        from .tpe import build_suggest_fn

        model = build_suggest_fn(ps, n_cand, float(gamma), lf_f, pw, joint_ei=joint_ei,
                                 n_cand_cat=n_cand_cat)
    elif algo == "anneal":
        from .anneal import build_anneal_fn

        model = build_anneal_fn(ps, avg_best_idx, shrink_coef)
    elif algo == "atpe":
        from .atpe import build_atpe_device_fn

        model = build_atpe_device_fn(ps, lf_f, prior_weight=pw, base_n_ei=n_cand,
                                     n_cand_cat=n_cand_cat,
                                     mesh=mesh if cand_axis is not None else None,
                                     cand_axis=cand_axis)
    else:
        model = None

    accepts_active = not trainable and "active" in inspect.signature(fn).parameters
    init_accepts_active = trainable and "active" in inspect.signature(fn.init_fn).parameters
    labels = ps.labels

    def eval_plain(key, values, active, lo=0):
        """values/active [D, b] (the batch's columns from ``lo`` on) ->
        losses [b] through the user's objective."""
        cfg = {label: values[d] for d, label in enumerate(labels)}
        if accepts_active:
            out = fn(cfg, active={label: active[d] for d, label in enumerate(labels)})
        else:
            out = fn(cfg)
        return torch.broadcast_to(torch.as_tensor(out).to(torch.float32), values.shape[-1:])

    def _trial_cfg(vcol, acol):
        # inactive-branch dims pinned to 0.0, as the host driver omits them
        return {label: torch.where(acol[d], vcol[d], 0.0) for d, label in enumerate(labels)}

    def eval_trainable(key, values, active, lo=0):
        """Per-trial init, ``n_epochs`` training epochs and loss, mapped
        over the trial batch (its columns from ``lo`` on) with
        ``torch.func.vmap``."""
        ekeys = R.split(R.fold_in(key, _TRAIN_TAG), B)[lo:lo + values.shape[-1]]

        def one(vcol, acol, k):
            cfg = _trial_cfg(vcol, acol)
            if init_accepts_active:
                state = fn.init_fn(k, cfg, active={label: acol[d]
                                                   for d, label in enumerate(labels)})
            else:
                state = fn.init_fn(k, cfg)
            for epoch in range(fn.n_epochs):
                state = fn.step_fn(state, cfg, epoch)
            return fn.loss_fn(state, cfg)

        return torch.func.vmap(one, in_dims=(1, 1, 0))(values, active, ekeys).to(torch.float32)

    chunk_steps = n_chunks = None
    if chunked:
        chunk_steps = -(-int(chunk_size) // B)
        n_chunks = -(-n_steps // chunk_steps)
    a_spec = None
    if asha is not None:
        from .hyperband import rung_schedule

        a_eta = int(asha.get("eta", 2))
        a_rung_epochs = int(asha.get("rung_epochs", 1))
        try:
            ladder = rung_schedule(B, a_eta, asha.get("n_rungs"), a_rung_epochs)
        except ValueError as e:
            raise ValueError(
                f"asha bracket geometry: {e} (batch_size is the bracket population)") from None

        def init_one(k, vcol, acol):
            cfg = _trial_cfg(vcol, acol)
            if init_accepts_active:
                return fn.init_fn(k, cfg, active={label: acol[d]
                                                  for d, label in enumerate(labels)})
            return fn.init_fn(k, cfg)

        def init_states(keys, values, active):
            return torch.func.vmap(init_one, in_dims=(0, 1, 1))(keys, values, active)

        # ONE sub-mesh for the whole program, sized by the smallest rung:
        # every wider rung is a power-of-eta multiple of it, so one gcd
        # covers the ladder (reported only: inside one process the rungs
        # train as the unsharded body)
        a_k = 1
        if shard_trials:
            from .parallel.mesh import rung_submesh

            a_k = rung_submesh(mesh, trial_axis, ladder[-1][0])[1]

        def rung_trainer(n_ep, e0):
            """Rung training at a static width: every survivor advances
            ``n_ep`` epochs from the cumulative offset ``e0`` (its epoch
            counter runs on across rungs), then reports its loss."""

            def one(state, vcol, acol):
                cfg = _trial_cfg(vcol, acol)
                for epoch in range(e0, e0 + n_ep):
                    state = fn.step_fn(state, cfg, epoch)
                return state, fn.loss_fn(state, cfg)

            def train(states, values, active):
                states, losses = torch.func.vmap(one, in_dims=(0, 1, 1))(states, values, active)
                return states, losses.to(torch.float32)

            return train

        a_spec = _Asha(a_eta, a_rung_epochs, ladder, init_states,
                       [rung_trainer(n_ep, e0) for _, n_ep, e0 in ladder],
                       artifact_callback is not None, chunk_steps, D)

    loop = _Loop(
        ps, D, B, cap, int(n_startup_jobs), algo, model,
        eval_trainable if trainable else eval_plain, early,
        -math.inf if loss_threshold is None else float(loss_threshold),
        n_steps + 1 if no_progress_steps is None else int(no_progress_steps),
        asha=a_spec, ranks=trial_ranks,
    )
    programs = {}

    def program(n_seeds=None):
        """The loop's program for one experiment (or ``n_seeds`` in
        lockstep), built and, on the card, captured at first use."""
        prog = programs.get(n_seeds)
        if prog is None:
            prog = programs[n_seeds] = _Program(loop, n_seeds)
        return prog

    cat_dims = set(ps.cat_idx.tolist())

    def _unpack_init(init):
        iv = np.asarray(init["values"], dtype=np.float32)
        ia = np.asarray(init["active"], dtype=bool)
        il = np.asarray(init["losses"], dtype=np.float32)
        c0 = il.shape[0]
        if c0 > W:
            raise ValueError(
                f"init history has {c0} trials but warm_capacity={W}; recompile with a "
                "larger warm_capacity"
            )
        values0 = np.zeros((D, cap), dtype=np.float32)
        active0 = np.zeros((D, cap), dtype=bool)
        losses0 = np.zeros(cap, dtype=np.float32)
        valid0 = np.zeros(cap, dtype=bool)
        values0[:, :c0] = iv
        active0[:, :c0] = ia
        losses0[:c0] = il
        valid0[:c0] = True
        fin = il[np.isfinite(il)]
        best0 = float(fin.min()) if fin.size else math.inf  # early stop sees the warm best
        return (values0, active0, losses0, valid0), c0, best0

    def _asha_best(losses_np, rung_np):
        """The best full-fidelity trial; if every one failed, the best
        finite loss at any rung (so a config can still be named)."""
        fin = np.isfinite(losses_np)
        keyed = np.where(fin & (rung_np == len(a_spec.ladder) - 1), losses_np, np.inf)
        if not np.isfinite(keyed).any():
            keyed = np.where(fin, losses_np, np.inf)
        return int(np.argmin(keyed))

    def _package_result(values_np, active_np, losses_np, n_ran, total, return_trials,
                        rung_of_np=None):
        if not np.isfinite(losses_np).any():
            raise AllTrialsFailed("every on-device trial returned a non-finite loss")
        if rung_of_np is not None:
            bi = _asha_best(losses_np, rung_of_np)
        else:
            bi = int(np.argmin(np.where(np.isfinite(losses_np), losses_np, np.inf)))
        best = {}
        for d, label in enumerate(labels):
            if not active_np[d, bi]:
                continue
            v = float(values_np[d, bi])
            best[label] = int(round(v)) if d in cat_dims else v
        out = {
            "best": best,
            "best_loss": float(losses_np[bi]),
            "best_index": bi,
            # the whole history (warm prefix and this run): init= of the next leg
            "losses": losses_np,
            "values": values_np,
            "active": active_np,
            "n_evals": n_ran,
            "n_total": total,
        }
        if rung_of_np is not None:
            out["rung_of"] = rung_of_np
            out["asha"] = a_spec.metadata()
        if return_trials:
            out["trials"] = _to_trials(ps, values_np, active_np, losses_np)
        return out

    def _replay_steps(prog, c0):
        """Replay the whole experiment; early stop polls the flag."""
        for j in range(n_steps):
            prog.run(loop.regime(j, c0))
            if early and (j + 1) % STOP_POLL == 0 and prog.stopped():
                break

    def _finish(prog, c0, return_trials):
        host = prog.host_state()
        values, active, losses = host[:3]
        n_ran = (int(prog.n_done) if early else n_steps) * B
        total = c0 + n_ran
        return _package_result(values[:, :total], active[:, :total], losses[:total], n_ran,
                               total, return_trials,
                               rung_of_np=host[4][:total] if a_spec is not None else None)

    def _runner_flat(seed, return_trials, init):
        prog = program()
        state, c0, best0 = (None, 0, math.inf) if init is None else _unpack_init(init)
        prog.reset(seed, state, c0, best0)
        _replay_steps(prog, c0)
        return _finish(prog, c0, return_trials)

    def _runner_seeds(seeds, return_trials):
        """The seed sweep: S experiments in lockstep over a seed axis."""
        prog = program(len(seeds))
        prog.reset(seeds, None, 0, math.inf)
        _replay_steps(prog, 0)
        values, active, losses, _ = prog.host_state()
        n_done = prog.n_done.cpu().numpy() if early else np.full(len(seeds), n_steps)
        outs = []
        for s in range(len(seeds)):
            n_ran = int(n_done[s]) * B
            outs.append(_package_result(values[s][:, :n_ran], active[s][:, :n_ran],
                                        losses[s][:n_ran], n_ran, n_ran, return_trials))
        return outs

    ck_guard = None
    if chunked and checkpoint_path is not None:
        from .hyperband import _algo_identity, _space_fingerprint
        from .pyll.base import as_apply

        ck_guard = [
            "device-loop-chunk", 1, str(algo), _space_fingerprint(as_apply(space)),
            _algo_identity(fn), int(n_steps), int(B), int(chunk_steps), int(cap),
        ]
        if a_spec is not None:
            # the rung geometry is part of the experiment: a bundle from
            # another ladder is refused
            ck_guard += ["asha", a_spec.eta, a_spec.rung_epochs, len(a_spec.ladder)]

    def _runner_chunked(seed, return_trials, init, resume_now):
        from .distributed.faults import REAL_FS
        from .utils.checkpoint import load_device_chunk, save_device_chunk

        fs_ = REAL_FS if fs is None else fs
        seed_u = int(seed) % (2**32)
        state, c0, start_chunk, rung_of = None, 0, 0, None
        init_state = init_c0 = None
        if init is not None:
            init_state, init_c0, _ = _unpack_init(init)
        if resume_now:
            if checkpoint_path is None:
                raise ValueError("resume=True needs checkpoint_path")
            if fs_.exists(checkpoint_path):
                bundle = load_device_chunk(checkpoint_path, guard=ck_guard, fs=fs_)
                if int(bundle["seed"]) != seed_u:
                    raise CheckpointError(
                        f"chunk checkpoint {checkpoint_path!r} was written by seed "
                        f"{bundle['seed']}; this run uses seed {seed_u} -- the resumed stream "
                        "would diverge; refusing to resume"
                    )
                if init_c0 is not None and int(bundle["c0"]) != init_c0:
                    raise CheckpointError(
                        f"chunk checkpoint {checkpoint_path!r} records a warm offset of "
                        f"{bundle['c0']} trials but init= holds {init_c0}; refusing to resume"
                    )
                c0 = int(bundle["c0"])
                start_chunk = int(bundle["chunk_next"])
                state = (bundle["values"], bundle["active"], bundle["losses"], bundle["valid"])
                rung_of = bundle.get("rung_of")
        if state is None and init_state is not None:
            state, c0 = init_state, init_c0
        prog = program()
        prog.reset(seed_u, state, c0, math.inf, start_step=start_chunk * chunk_steps,
                   rung_of=rung_of)
        for ci in range(start_chunk, n_chunks):
            # a padded tail chunk's steps past n_steps are not replayed
            last = min((ci + 1) * chunk_steps, n_steps)
            for j in range(ci * chunk_steps, last):
                prog.run(loop.regime(j, c0))
            if artifact_callback is not None:
                # the chunk's winner rows, read where the progress row is
                # (copies: the next chunk writes the same buffer)
                win = tree_map(host_copy, prog.win)
                for j in range(last - ci * chunk_steps):
                    artifact_callback({
                        "bracket": ci * chunk_steps + j,
                        "slot": int(win["slot"][j]),
                        "loss": float(win["loss"][j]),
                        "params": tree_map(lambda x, j=j: x[j], win["params"]),
                    })
            if progress_callback is not None and (
                (ci + 1) % int(progress_every) == 0 or ci == n_chunks - 1
            ):
                best, done = prog.summary()
                progress_callback({"chunk": ci, "trials_done": int(done),
                                   "best_loss": float(best)})
            fs_.crashpoint("device_loop_after_chunk_before_ckpt")
            if checkpoint_path is not None and (
                (ci + 1) % int(checkpoint_every) == 0 or ci == n_chunks - 1
            ):
                host = prog.host_state()
                bundle = {
                    "guard": ck_guard, "seed": seed_u, "c0": int(c0), "chunk_next": ci + 1,
                    "n_chunks": int(n_chunks), "values": host[0], "active": host[1],
                    "losses": host[2], "valid": host[3],
                }
                if a_spec is not None:
                    bundle["rung_of"] = host[4]
                save_device_chunk(checkpoint_path, bundle, fs=fs_)
                fs_.crashpoint("device_loop_after_ckpt_before_next_chunk")
        return _finish(prog, c0, return_trials)

    resume_default = bool(resume)

    def runner(seed=0, return_trials=False, init=None, resume=None):
        if chunked:
            if _is_seed_list(seed):
                raise ValueError(
                    "chunk_size does not compose with vectorized seed sweeps; run seeds "
                    "individually"
                )
            resume_now = bool(resume_default if resume is None else resume)
            return _runner_chunked(seed, return_trials, init, resume_now)
        if resume:
            raise ValueError(
                "resume rides the chunked path; pass chunk_size= (and checkpoint_path=) to "
                "compile_fmin"
            )
        if _is_seed_list(seed):
            if a_spec is not None:
                raise ValueError(
                    "asha= does not compose with vectorized seed sweeps; run seeds individually")
            if init is not None:
                raise ValueError(
                    "init= resume is single-seed; run the seed sweep fresh or resume seeds "
                    "individually"
                )
            return _runner_seeds(list(seed), return_trials)
        return _runner_flat(seed, return_trials, init)

    # the program (carry, eager step, captured graphs, replay counts) of
    # one experiment, or of a seed sweep: program(n_seeds)
    runner._program = program
    runner._packed_space = ps
    if a_spec is not None:
        runner._asha_ladder = list(a_spec.ladder)
        # the reference's rung sub-mesh size
        runner._asha_submesh_devices = a_k
    if chunked:
        runner._chunk_geometry = {
            "chunk_steps": chunk_steps,
            "n_chunks": n_chunks,
            "n_steps": n_steps,
            "batch_size": B,
        }
    return runner


def fmin_on_device(fn, space, max_evals, seed=0, return_trials=False, **kw):
    """One-shot convenience over :func:`compile_fmin` (builds and captures
    at every call; use ``compile_fmin`` directly to reuse a runner)."""
    return compile_fmin(fn, space, max_evals, **kw)(seed=seed, return_trials=return_trials)


def _to_trials(ps, values, active, losses, trials=None):
    """Rebuild a host ``Trials`` store from the history (into ``trials``
    when given, the ``fmin(compiled=True)`` route; a fresh one otherwise)."""
    from .base import JOB_STATE_DONE, STATUS_FAIL, STATUS_OK, Trials

    if trials is None:
        trials = Trials()
    n = values.shape[1]
    ids = trials.new_trial_ids(n)
    cat = set(ps.cat_idx.tolist())
    miscs = []
    for i, tid in enumerate(ids):
        t_idxs, t_vals = {}, {}
        for d, label in enumerate(ps.labels):
            if active[d, i]:
                v = float(values[d, i])
                t_idxs[label] = [tid]
                t_vals[label] = [int(round(v)) if d in cat else v]
            else:
                t_idxs[label] = []
                t_vals[label] = []
        miscs.append({
            "tid": tid,
            "cmd": ("domain_attachment", "FMinIter_Domain"),
            "workdir": None,
            "idxs": t_idxs,
            "vals": t_vals,
        })
    results = [
        {"status": STATUS_OK, "loss": float(losses[i])}
        if np.isfinite(losses[i])
        else {"status": STATUS_FAIL, "loss": None}
        for i in range(n)
    ]
    docs = trials.new_trial_docs(ids, [None] * n, results, miscs)
    for doc in docs:
        doc["state"] = JOB_STATE_DONE
    trials.insert_trial_docs(docs)
    trials.refresh()
    return trials
