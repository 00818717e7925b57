"""Successive halving, Hyperband and ASHA: host drivers, and fused on the
card.

The counterpart of :mod:`hyperopt_tpu.hyperband`.  Budget-aware
schedulers (Li et al., 2018) evaluate many configurations at a small
budget, keep the top ``1/eta`` at each rung and spend the saved budget on
the survivors.

* :func:`successive_halving`, :func:`hyperband`, :func:`asha` and the
  BOHB-style :func:`budget_aware` wrapper are host drivers over any
  ``fn(config, budget) -> loss``: rung-0 configurations come through
  the algo seam (the default is the host random search of
  :mod:`hyperopt_tpu_torch.rand_host`, the reference's default; with the
  port's ``tpe.suggest`` they are suggested on the card) and every
  evaluation is recorded in a ``Trials`` store with ``result["budget"]``.
* :func:`compile_sha` and :func:`compile_hyperband` halve over training
  on the card: rung ``r`` trains its population ``steps_per_rung *
  eta**r`` steps of the user's ``train_fn`` (the
  :mod:`hyperopt_tpu_torch.pbt` contract), ranks it with
  :func:`rung_rank` and gathers the survivors into the next rung's
  narrower static tensors.  Each rung is one captured
  ``torch.cuda.CUDAGraph``; the chain of replays runs back to back and
  the host reads the bookkeeping once at the end (once per rung when
  checkpointing).  Over real ranks a rung is two graphs with a host
  gather between them (:func:`compile_sha`).

:func:`rung_schedule` and :func:`rung_rank` are the geometry and the
promotion rule shared with the compiled loop's fused ASHA brackets
(:func:`hyperopt_tpu_torch.device_loop.compile_fmin` with ``asha=``).
"""

from __future__ import annotations

import functools
import hashlib
import logging
import math
import os

import numpy as np
import torch

from . import random as R
from .distributed.faults import REAL_FS
from .pyll.base import Literal, dfs
from .utils import capture_graph, host_copy, resolve_device, tree_leaves, tree_map
from .utils.population import copy_into, hypers_dict, log_bounds, log_uniform_start, to_device
from .pbt import _gather, _gather_ranks, _play, _resolve_shard_mode, _scatter, _train_blocks

logger = logging.getLogger(__name__)

__all__ = [
    "asha",
    "budget_aware",
    "compile_hyperband",
    "compile_sha",
    "hyperband",
    "rung_rank",
    "rung_schedule",
    "successive_halving",
]


def _budgets_integral(max_budget, min_budget):
    """The integral-budget rule every driver shares: ``fn`` sees ints when
    ``max_budget`` is integral (any ``numbers.Integral``, numpy ints too)
    and ``min_budget`` is a whole number."""
    import numbers

    return isinstance(max_budget, numbers.Integral) and float(min_budget) == round(
        float(min_budget))


def _algo_identity(algo):
    """Checkpoint-guard identity of an algo or objective: its module and
    qualified name (``functools.partial`` unwraps to its base function;
    tuned kwargs are not fingerprinted)."""
    a = algo
    while isinstance(a, functools.partial):
        a = a.func
    return (
        f"{getattr(a, '__module__', '?')}."
        f"{getattr(a, '__qualname__', type(a).__name__)}"
    )


def _check_evaluator_arity(evaluator):
    """Fail fast on an evaluator that cannot take ``(vals, cfg, budget)``;
    a callable without an introspectable signature is accepted."""
    import inspect

    try:
        sig = inspect.signature(evaluator)
    except (ValueError, TypeError):
        return
    try:
        sig.bind({}, {}, 1)
    except TypeError:
        raise TypeError(f"evaluator must accept (vals, cfg, budget); got signature {sig}")


def _rstate_fingerprint(rstate):
    """Checkpoint-guard identity of a generator's current position: its
    state serialized canonically (sorted-key json, arrays as lists) and
    hashed."""
    import json

    def norm(v):
        if isinstance(v, dict):
            return {k: norm(v[k]) for k in sorted(v)}
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
        return v

    blob = json.dumps(norm(rstate.bit_generator.state), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _rung_budget(min_budget, eta, r, integral):
    """Rung ``r``'s budget under the integral rule, for every host driver."""
    b = float(min_budget) * eta**r
    return int(round(b)) if integral else b


def _vals_of(doc):
    """Index-form config of a suggested trial doc (single-valued labels
    only: an inactive branch's label has an empty list)."""
    return {k: v[0] for k, v in doc["misc"]["vals"].items() if len(v) == 1}


def _int_log(ratio, eta):
    """The largest integer k with ``eta**k <= ratio``, tolerant of float
    error at exact powers (``math.log`` gives 4.9999... for 243, 3)."""
    k = 0
    b = 1.0
    while b * eta <= ratio * (1 + 1e-9):
        b *= eta
        k += 1
    return k


def rung_schedule(n_configs, eta, n_rungs=None, steps_per_rung=1):
    """The successive-halving ladder ``[(width, steps, offset), ...]``
    shared by :func:`compile_sha` and the compiled loop's ASHA brackets:
    rung ``r`` runs its ``n_configs // eta**r`` survivors for
    ``steps_per_rung * eta**r`` further steps from the cumulative
    ``offset``.  ``n_configs`` must be a power of ``eta``; ``n_rungs``
    defaults to halving down to one survivor."""
    p0 = int(n_configs)
    eta = int(eta)
    if eta < 2:
        raise ValueError(f"eta={eta} must be >= 2")
    max_rungs = _int_log(p0, eta)
    if eta**max_rungs != p0:
        raise ValueError(f"n_configs={p0} must be a power of eta={eta}")
    if n_rungs is None:
        n_rungs = max_rungs + 1
    if not 1 <= int(n_rungs) <= max_rungs + 1:
        raise ValueError(
            f"n_rungs={n_rungs} must be in [1, {max_rungs + 1}] for n_configs={p0}, eta={eta}"
        )
    ladder = []
    offset = 0
    for r in range(int(n_rungs)):
        steps = int(steps_per_rung) * eta**r
        ladder.append((p0 // eta**r, steps, offset))
        offset += steps
    return ladder


def rung_rank(losses, replicas, p_live):
    """The promotion ranking on the card: ``[R * p_live]`` losses ->
    ``[R, p_live]`` global member indices, best first within each
    bracket.  Non-finite losses key to ``+inf`` (last); ties break by
    member order (a stable sort), so every execution model promotes the
    same members."""
    keyed = torch.where(torch.isfinite(losses), losses, torch.inf)
    order = torch.argsort(keyed.reshape(replicas, p_live), dim=1, stable=True)
    base = torch.arange(replicas, dtype=order.dtype, device=order.device)[:, None] * p_live
    return order + base


def _default_algo(algo):
    if algo is None:
        from . import rand_host

        return rand_host.suggest
    return algo


def successive_halving(
    fn,
    space,
    max_budget,
    eta=3,
    n_configs=None,
    min_budget=1,
    algo=None,
    trials=None,
    rstate=None,
    checkpoint=None,
    checkpoint_every=1,
    device=None,
):
    """One successive-halving bracket over ``fn(config, budget) -> loss``
    (or a dict with ``"loss"``), the reference's
    :func:`hyperopt_tpu.hyperband.successive_halving`.

    Rung budgets grow by ``eta`` from ``min_budget`` to ``max_budget``
    (integral when ``max_budget`` is an int and ``min_budget`` whole);
    ``n_configs`` defaults to ``eta ** (n_rungs - 1)``; ``algo`` suggests
    the rung-0 configs (default: host random search); every evaluation is
    a completed trial in ``trials`` with ``result["budget"]``, a promotion
    a new trial.  ``checkpoint`` (a path) snapshots the run every
    ``checkpoint_every`` evaluations and at every rung boundary, and a
    later call resumes it bitwise; a snapshot from another ladder, space,
    algo, objective or seed is refused.  ``device`` is the domain's (where
    a device algo such as the port's ``tpe.suggest`` computes).

    Returns ``{"best": config, "best_loss", "rungs": [...], "trials"}``.
    """
    import copy

    from .base import Domain, Trials
    from .fmin import space_eval

    if rstate is None:
        rstate = np.random.default_rng()
    algo = _default_algo(algo)
    if trials is None:
        trials = Trials()
    n_rungs = _int_log(max_budget / min_budget, eta) + 1
    if n_configs is None:
        n_configs = eta ** (n_rungs - 1)
    domain = Domain(fn, space, pass_expr_memo_ctrl=False, device=device)
    integral = _budgets_integral(max_budget, min_budget)

    # the generator's position BEFORE the seed draw identifies the run
    rs_fp = _rstate_fingerprint(rstate)
    snap = None
    ck_guard = None
    if checkpoint is not None:
        if int(checkpoint_every) < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every!r}")
        ck_guard = (
            "sha", n_rungs, float(max_budget), float(min_budget), float(eta), int(n_configs),
            _algo_identity(algo), _algo_identity(fn), _space_fingerprint(domain.expr), rs_fp,
        )
        if os.path.exists(checkpoint):
            # refused BEFORE the seed draw: a refusal leaves rstate alone
            from .utils.checkpoint import load_guarded

            snap = load_guarded(checkpoint, ck_guard)
    # always drawn, resuming or not: a caller sharing one rstate across
    # brackets (hyperband) sees the same stream either way
    seed = int(rstate.integers(0, 2**31 - 1))

    def config_of(doc):
        return space_eval(space, _vals_of(doc))

    def _docs_by_tid(wanted):
        m = {t["tid"]: t for t in trials._dynamic_trials}
        return [m[t] for t in wanted]

    if snap is None:
        ids = trials.new_trial_ids(n_configs)
        docs = algo(ids, domain, trials, seed)
        trials.insert_trial_docs(docs)
        trials.refresh()
        # the STORED docs receive the results
        tids = {d["tid"] for d in docs}
        live = [t for t in trials._dynamic_trials if t["tid"] in tids]
        r0, j0, rungs, new_ids, scored_tids = 0, 0, [], None, []
    else:
        trials = snap["trials"]
        live = _docs_by_tid(snap["live_tids"])
        r0, j0 = snap["r"], snap["j"]
        rungs = snap["rungs"]
        new_ids = snap["new_ids"]
        scored_tids = snap["scored"]  # [(loss, tid)] of the partial rung

    def _write(r, j, scored, live, rungs, new_ids):
        from .utils.checkpoint import save_trials

        save_trials({
            "guard": ck_guard,
            "trials": trials,
            "r": r,
            "j": j,
            "scored": [(loss, d["tid"]) for loss, d in scored],
            "live_tids": [d["tid"] for d in live],
            "rungs": rungs,
            "new_ids": new_ids,
        }, checkpoint)

    scored = None  # stays None when resuming an already finished run
    for r in range(r0, n_rungs):
        b = _rung_budget(min_budget, eta, r, integral)
        if r > 0 and new_ids is None:
            new_ids = trials.new_trial_ids(len(live))
        if r == r0 and scored_tids:
            restored = _docs_by_tid([t for _, t in scored_tids])
            scored = [(loss, d) for (loss, _), d in zip(scored_tids, restored)]
        else:
            scored = []
        for j in range(j0 if r == r0 else 0, len(live)):
            doc = live[j]
            loss = fn(config_of(doc), b)
            if isinstance(loss, dict):
                loss = loss["loss"]
            result = {"status": "ok", "loss": float(loss), "budget": b}
            if r == 0:
                # rung 0 completes the suggested trials themselves
                doc["result"] = result
                doc["state"] = 2  # JOB_STATE_DONE
                rec = doc
            else:
                # a promotion appends a NEW trial per (config, budget): the
                # lower rungs' results stay as learning-curve history
                tid = new_ids[j]
                misc = copy.deepcopy(doc["misc"])
                misc["tid"] = tid
                misc["idxs"] = {k: ([tid] if v else []) for k, v in misc["idxs"].items()}
                (rec,) = trials.new_trial_docs([tid], [None], [result], [misc])
                rec["state"] = 2
                trials.insert_trial_docs([rec])
                # the stored copy is the record scored and promoted from
                for t in reversed(trials._dynamic_trials):
                    if t["tid"] == tid:
                        rec = t
                        break
            scored.append((float(loss), rec))
            if (checkpoint is not None and (j + 1) % int(checkpoint_every) == 0
                    and j + 1 < len(live)):  # the rung-boundary write follows
                _write(r, j + 1, scored, live, rungs, new_ids)
        trials.refresh()
        scored.sort(key=lambda t: (not np.isfinite(t[0]), t[0]))
        rungs.append({"budget": b, "n": len(scored), "best_loss": scored[0][0]})
        n_keep = max(1, len(scored) // eta)
        live = [doc for _, doc in scored[:n_keep]]
        new_ids = None
        if checkpoint is not None:
            _write(r + 1, 0, [], live, rungs, None)
    if scored is None:
        # resumed a snapshot written at the final rung boundary: the run
        # had finished; its answer is the last rung's best
        best_loss, best_doc = rungs[-1]["best_loss"], live[0]
    else:
        best_loss, best_doc = scored[0]
    return {"best": config_of(best_doc), "best_loss": best_loss, "rungs": rungs,
            "trials": trials}


def hyperband(fn, space, max_budget, eta=3, min_budget=1, algo=None, rstate=None,
              trials=None, checkpoint=None, checkpoint_every=1, device=None):
    """Hyperband (the reference's :func:`hyperopt_tpu.hyperband.hyperband`):
    every successive-halving bracket from the most exploratory to a single
    full-budget one, sharing one ``Trials`` store; returns the overall
    best.  ``checkpoint`` makes the spread durable: a bracket-boundary
    snapshot at ``checkpoint`` plus each bracket's own at
    ``checkpoint + ".s<s>"``; a later call skips finished brackets and
    resumes the one in flight, bitwise."""
    from .base import Trials

    if rstate is None:
        rstate = np.random.default_rng()
    if trials is None:
        trials = Trials()
    s_max = _int_log(max_budget / min_budget, eta)
    best = None
    brackets = []
    s0 = s_max
    ck_guard = None
    if checkpoint is not None:
        from .base import Domain

        ck_guard = (
            "hyperband", s_max, float(max_budget), float(min_budget), float(eta),
            type(rstate.bit_generator).__name__, _algo_identity(_default_algo(algo)),
            _algo_identity(fn),
            _space_fingerprint(Domain(fn, space, pass_expr_memo_ctrl=False,
                                      device=device).expr),
            # the generator's entry position: the run's identity
            _rstate_fingerprint(rstate),
        )
        if os.path.exists(checkpoint):
            from .utils.checkpoint import load_guarded

            snap = load_guarded(checkpoint, ck_guard)
            trials = snap["trials"]
            brackets = snap["brackets"]
            best = snap["best"]
            s0 = snap["next_s"]
            rstate = np.random.Generator(type(rstate.bit_generator)())
            rstate.bit_generator.state = snap["rstate"]
            # brackets the main snapshot subsumes leave no stale file
            for s in range(s_max, s0, -1):
                try:
                    os.remove(f"{checkpoint}.s{s}")
                except FileNotFoundError:
                    pass
    for s in range(s0, -1, -1):
        n = int(math.ceil((s_max + 1) * eta**s / (s + 1)))
        out = successive_halving(
            fn, space, max_budget=max_budget, min_budget=max_budget / eta**s, eta=eta,
            n_configs=n, algo=algo, trials=trials, rstate=rstate,
            checkpoint=None if checkpoint is None else f"{checkpoint}.s{s}",
            checkpoint_every=checkpoint_every, device=device,
        )
        trials = out["trials"]  # a resumed bracket restored its own store
        brackets.append({"s": s, "rungs": out["rungs"]})
        if best is None or out["best_loss"] < best["best_loss"]:
            best = {"best": out["best"], "best_loss": out["best_loss"]}
        if checkpoint is not None:
            from .utils.checkpoint import save_trials

            save_trials({
                "guard": ck_guard,
                "trials": trials,
                "brackets": brackets,
                "best": best,
                "next_s": s - 1,
                "rstate": rstate.bit_generator.state,
            }, checkpoint)
            # the bracket is subsumed now; its file would block a fresh run
            try:
                os.remove(f"{checkpoint}.s{s}")
            except FileNotFoundError:
                pass
    return {"best": best["best"], "best_loss": best["best_loss"], "brackets": brackets,
            "trials": trials}


def budget_aware(base_algo=None, min_obs=8):
    """BOHB-style model fitting for rung-0 suggestions (the reference's
    :func:`hyperopt_tpu.hyperband.budget_aware`): the wrapped algo fits
    only the observations of the highest budget with at least ``min_obs``
    completed trials (else the most populated budget, else everything).
    The default base algo is the port's ``tpe.suggest``."""
    from collections import Counter

    from .base import trials_from_docs

    def algo(new_ids, domain, trials, seed, **kw):
        nonlocal base_algo
        if base_algo is None:
            from . import tpe

            base_algo = tpe.suggest
        counts = Counter(
            t["result"]["budget"]
            for t in trials.trials
            if t.get("result")
            and t["result"].get("loss") is not None
            and t["result"].get("budget") is not None
        )
        if counts:
            eligible = [b for b, c in counts.items() if c >= min_obs]
            target = max(eligible) if eligible else max(counts, key=lambda b: (counts[b], b))
            docs = [t for t in trials.trials
                    if t.get("result") is not None and t["result"].get("budget") == target]
            filtered = trials_from_docs(docs, validate=False)
            return base_algo(new_ids, domain, filtered, seed, **kw)
        return base_algo(new_ids, domain, trials, seed, **kw)

    return algo


def _init_takes_seed(init_state):
    """Whether a callable ``init_state`` takes the runner's seed: only
    through a required positional parameter (a default-capture lambda
    keeps the zero-argument call)."""
    import inspect

    try:
        return any(
            p.default is inspect.Parameter.empty
            and p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                           inspect.Parameter.POSITIONAL_OR_KEYWORD)
            for p in inspect.signature(init_state).parameters.values()
        )
    except (TypeError, ValueError):
        return False


def compile_sha(
    train_fn,
    init_state,
    hyper_bounds,
    n_configs,
    eta=2,
    steps_per_rung=5,
    n_rungs=None,
    mesh=None,
    trial_axis="trial",
    replicas=1,
    shard_mode=None,
    device=None,
    fs=None,
):
    """Successive halving over training on ``device`` (None = the card;
    ``"cpu"`` runs the same rungs eagerly), the reference's
    :func:`hyperopt_tpu.hyperband.compile_sha`.

    Rung ``r`` trains its population ``steps_per_rung * eta**r`` steps of
    ``train_fn(state, hypers, key) -> (state, losses)`` (the
    :func:`hyperopt_tpu_torch.pbt.compile_pbt` contract), then the top
    ``1/eta`` of each bracket, states and log-space hypers, are gathered
    into the next rung's narrower static tensors: survivors continue from
    their trained state.  Hypers start log-uniform in ``hyper_bounds``.
    ``replicas=K`` packs K independent brackets into every rung (ranked
    within each bracket); ``init_state`` leaves then lead with ``K *
    n_configs``.  ``init_state`` may be a callable (``init_state(seed)``
    when it takes a required argument, else ``init_state()``), called
    once per run.

    ``mesh`` (a 1-D mesh along ``trial_axis`` inside this process) with
    ``shard_mode="shard_map"`` shards every rung over the gcd-sized
    sub-mesh of :func:`~hyperopt_tpu_torch.parallel.mesh.rung_submesh`:
    the rung's member blocks train on their own, the rung's losses are
    gathered once for the ranking, and the survivors are gathered into
    the next rung's blocks (a rung on one shard is the unsharded rung:
    one block, the rung's population itself).  The ladder is bitwise the unsharded one for
    a ``train_fn`` whose per-member math does not depend on the member's
    place in the batch.  ``"constraint"`` (the default with a mesh, as in
    the reference, where GSPMD computes the unsharded math) checks the
    mesh and runs the unsharded rungs, bit for bit the ladder without a
    mesh.  ``runner._rung_meshes`` holds each rung's sub-mesh.

    On a 1-D ``trial`` mesh of real ranks, one process each, rank ``i``
    owns block ``i`` of every rung whose sub-mesh holds it (the others
    wait out that rung).  A ``gloo`` gather cannot sit inside a captured
    graph, so a rung is two graphs with the host between them: the
    rank's block trains (one graph), the host gathers every rank's block
    losses and block states (one
    :func:`~hyperopt_tpu_torch.parallel.multihost.fetch_global` each: one
    ``all_gather`` of the losses, one of the states), and the ranking
    and the survivor gather run over the whole rung, replicated on every
    rank (the second graph).  ``checkpoint=`` is single-process, as in
    the reference, and is refused there.

    On the card every rung is built once and captured as one graph at the
    first run; a run replays the chain back to back and reads the
    bookkeeping once at the end.  ``runner(seed=0, checkpoint=None)``
    returns ``{"best_loss", "best_hypers", "rungs": [{"n", "steps",
    "best_loss"}], "state", "best_index", "replica_bests"}``;
    ``checkpoint=path`` writes an ``.npz`` snapshot at every rung boundary
    (one host read per rung) and a later call with the same seed resumes
    from the last finished rung, bitwise; another seed or schedule is
    refused.  ``fs`` is the file seam of
    :mod:`hyperopt_tpu_torch.distributed.faults` the snapshots go through
    (its crash points: ``SHA_CRASH_POINTS`` and the writer's torn-publish
    window).
    """
    fs = REAL_FS if fs is None else fs
    mode = _resolve_shard_mode(shard_mode, mesh)
    dev = resolve_device(device)
    P0 = int(n_configs)
    Rn = int(replicas)
    if Rn < 1:
        raise ValueError(f"replicas={Rn} must be >= 1")
    eta = int(eta)
    ladder = rung_schedule(P0, eta, n_rungs, steps_per_rung)
    n_rungs = len(ladder)
    rung_meshes = [None] * n_rungs
    ranks = None
    if mode is not None:
        from .parallel.mesh import in_process_shards, over_processes, process_block, rung_submesh

        # rung r's members shard over the first gcd(members, n) shards
        if over_processes(mesh):
            ranks = process_block(mesh, trial_axis, "compile_sha")
        else:
            in_process_shards(mesh, trial_axis, "compile_sha", dev)
        rung_meshes = [rung_submesh(mesh, trial_axis, Rn * p)[0] for p, _, _ in ladder]

    def _validate_leading(state):
        leading = {x.shape[0] for x in tree_leaves(state)}
        if leading != {Rn * P0}:
            raise ValueError(
                f"init_state leaves must have leading dim replicas * n_configs = {Rn * P0}; "
                f"got {sorted(leading)}"
            )
        return state

    takes_seed = callable(init_state) and _init_takes_seed(init_state)
    if not callable(init_state):
        _validate_leading(init_state)
    names, log_lo, log_hi = log_bounds(hyper_bounds, dev)
    H = len(names)
    sched_guard = (P0, Rn, eta, int(n_rungs), int(steps_per_rung))

    def _materialize(seed):
        if not callable(init_state):
            return init_state
        return _validate_leading(init_state(int(seed)) if takes_seed else init_state())

    # the rungs' static tensors, made at the first run from one member's
    # leaf shapes and dtypes: rung r's population ``st[r]`` and hypers
    # ``lh[r]`` (width Rn * P0 / eta**r), its key, losses and order
    bufs = {}
    graphs = []

    def _owner_block(r):
        """Over real ranks, rung ``r``'s block of this rank: (its first
        member, its width, whether this rank trains it)."""
        m, k = Rn * ladder[r][0], rung_meshes[r].size
        return ranks[1] * (m // k), m // k, ranks[1] < k

    def _build(template):
        # one member's leaves, as shapes and dtypes only
        member = tree_map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"),
                          template)
        bufs["member"] = member
        bufs["st"], bufs["lh"], bufs["key"], bufs["losses"], bufs["order"] = [], [], [], [], []
        bufs["blocks"], bufs["blk_loss"] = [], []

        def zeros(m):
            return tree_map(lambda spec: torch.zeros((m,) + spec.shape, dtype=spec.dtype,
                                                     device=dev), member)

        for r, ((p, _, _), sub) in enumerate(zip(ladder, rung_meshes)):
            m = Rn * p
            # in-process blocks under shard_map only: "constraint" places
            k = sub.size if ranks is not None or mode == "shard_map" else 1
            st = zeros(m)
            bufs["st"].append(st)
            # the rung's member blocks: its population itself on one
            # shard, else k blocks that ``st`` gathers; over real ranks
            # this rank's block alone (an idle rank's sends zeros)
            if ranks is not None:
                bufs["blocks"].append([zeros(m // k)])
                bufs["blk_loss"].append(torch.zeros((m // k,), dtype=torch.float32, device=dev))
            else:
                bufs["blocks"].append([st] if k == 1 else [zeros(m // k) for _ in range(k)])
            bufs["lh"].append(torch.zeros((m, H), dtype=torch.float32, device=dev))
            bufs["key"].append(torch.zeros((2,), dtype=torch.int64, device=dev))
            bufs["losses"].append(torch.zeros((m,), dtype=torch.float32, device=dev))
            bufs["order"].append(torch.zeros((Rn, p), dtype=torch.int64, device=dev))

    def _place(r, full):
        """Copy rung ``r``'s population ``full`` into its member blocks
        (over real ranks, this rank's block, if it trains one)."""
        if ranks is None:
            _scatter(bufs["blocks"][r], full)
            return
        lo, n, owner = _owner_block(r)
        if owner:
            copy_into(bufs["blocks"][r][0], tree_map(lambda x: x[lo:lo + n], full))

    def _train(r):
        """Rung ``r``'s blocks, each trained on its own with its slice of
        the hypers: the trained blocks and their losses."""
        lo = 0 if ranks is None else _owner_block(r)[0]
        return _train_blocks(train_fn, bufs["blocks"][r], hypers_dict(bufs["lh"][r], names),
                             R.split(bufs["key"][r], ladder[r][1]), lo=lo)

    def _promote(r, losses, st):
        """Rank rung ``r`` on its gathered ``losses`` and gather the
        survivors of the population ``st`` into rung ``r + 1``'s blocks
        (the last rung keeps its trained population)."""
        p = ladder[r][0]
        order = rung_rank(losses, Rn, p)
        # each copy_ below is a no-op where the gather already wrote there
        bufs["losses"][r].copy_(losses)
        bufs["order"][r].copy_(order)
        if r < n_rungs - 1:
            keep = order[:, : p // eta].reshape(-1)
            copy_into(bufs["st"][r + 1], tree_map(lambda x: x.index_select(0, keep), st))
            bufs["lh"][r + 1].copy_(bufs["lh"][r].index_select(0, keep))
            _place(r + 1, bufs["st"][r + 1])
        else:
            copy_into(bufs["st"][r], st)

    def rung_step(r):
        """Rung ``r``: train every member block on its own with its slice
        of the hypers, rank on the gathered losses, and gather the
        survivors into rung ``r + 1``'s blocks (the last rung keeps its
        trained population)."""
        trained, blk_losses = _train(r)
        _promote(r, _gather(bufs["losses"][r], blk_losses), _gather(bufs["st"][r], trained))

    def rank_train(r):
        """Over real ranks, rung ``r``'s first graph: this rank's block
        trains (a rank the rung's sub-mesh leaves out has no such graph)."""
        (trained,), (losses,) = _train(r)
        copy_into(bufs["blocks"][r][0], trained)
        bufs["blk_loss"][r].copy_(losses)

    def rank_promote(r):
        """Over real ranks, rung ``r``'s second graph: the ranking and the
        survivor gather over the whole rung, replicated on every rank."""
        _promote(r, bufs["losses"][r], bufs["st"][r])

    # each rung's steps: one graph, or over real ranks two with the host
    # gather between them (None: a rung this rank does not train)
    rung_steps = ([[functools.partial(rung_step, r)] for r in range(n_rungs)] if ranks is None
                  else [[functools.partial(rank_train, r) if _owner_block(r)[2] else None,
                         functools.partial(rank_promote, r)] for r in range(n_rungs)])

    def play_rung(r, replay):
        _play(rung_steps[r], graphs[r] if replay else None,
              lambda: _gather_ranks(bufs["losses"][r], bufs["st"][r], bufs["blk_loss"][r],
                                    bufs["blocks"][r][0], ranks[2]), replay)

    def _ensure(template, eager):
        if not bufs:
            _build(template)
        if dev.type == "cuda" and not eager and not graphs:
            # the warm-ups write the buffers; every run fills them again
            graphs.extend([None if step is None else capture_graph(step, dev) for step in steps]
                          for steps in rung_steps)

    def _pop_after(rung):
        return Rn * (P0 // eta ** min(rung, n_rungs - 1))

    def _member_template():
        if "member" not in bufs:
            _build(to_device(_materialize(0), "cpu"))
        return bufs["member"]

    def _snapshot_target(rung):
        m = _pop_after(rung)
        state_t = tree_map(
            lambda spec: np.zeros((m,) + spec.shape,
                                  dtype=torch.empty(0, dtype=spec.dtype).numpy().dtype),
            _member_template(),
        )
        return {
            "meta": np.zeros(2 + len(sched_guard), np.int64),
            "log_h": np.zeros((m, H), np.float32),
            "state": state_t,
            "rungs": {
                "losses": [np.zeros((Rn * (P0 // eta**i),), np.float32) for i in range(rung)],
                "order": [np.zeros((Rn, P0 // eta**i), np.int32) for i in range(rung)],
            },
        }

    def _write_snapshot(path, rung, seed, log_h_np, state_np, per_rung):
        from .utils.checkpoint import save_pytree

        save_pytree({
            "meta": np.asarray([int(rung), int(seed), *sched_guard], np.int64),
            "log_h": log_h_np,
            "state": state_np,
            "rungs": {"losses": [l for l, _ in per_rung], "order": [o for _, o in per_rung]},
        }, path, fs=fs)

    def _read_snapshot(path, seed):
        from .utils.checkpoint import load_pytree, read_npz

        meta = read_npz(path, fs=fs)["['meta']"]
        rung = int(meta[0])
        if int(meta[1]) != int(seed) or tuple(int(x) for x in meta[2:]) != sched_guard:
            raise ValueError(
                f"checkpoint {path!r} was written by seed={int(meta[1])}, "
                f"schedule={tuple(int(x) for x in meta[2:])}; refusing to resume "
                f"seed={int(seed)}, schedule={sched_guard}"
            )
        snap = load_pytree(_snapshot_target(rung), path, fs=fs)
        return rung, snap["log_h"], snap["state"], list(
            zip(snap["rungs"]["losses"], snap["rungs"]["order"]))

    def _host_rung(r):
        # replicated on every rank: fetched locally
        from .parallel.multihost import fetch_global

        return fetch_global((bufs["losses"][r], bufs["order"][r].to(torch.int32)))

    def _run(seed, checkpoint, eager):
        if checkpoint is not None and ranks is not None:
            raise ValueError(
                f"compile_sha: checkpoint= (durable mode) is single-process, as in the "
                f"reference; this ladder's trial axis spans {mesh.size} processes")
        keys = R.split(R.key(int(seed) % 2**32, device=dev), n_rungs + 1)
        start = 0
        per_rung_host = []
        if checkpoint is not None and fs.exists(checkpoint):
            start, log_h0, state0, per_rung_host = _read_snapshot(checkpoint, seed)
            state0 = to_device(state0, dev)
            log_h0 = torch.from_numpy(log_h0).to(dev)
        else:
            log_h0 = log_uniform_start(keys[0], (Rn * P0, H), log_lo, log_hi)
            state0 = to_device(_materialize(seed), dev)
        if start < n_rungs:
            _ensure(state0, eager)
            _place(start, state0)
            bufs["lh"][start].copy_(log_h0)
            for r in range(n_rungs):
                bufs["key"][r].copy_(keys[r + 1])
            for r in range(start, n_rungs):
                play_rung(r, bool(graphs) and not eager)
                if checkpoint is not None:
                    # durable mode: one host read and one snapshot per rung
                    nxt = min(r + 1, n_rungs - 1)
                    per_rung_host.append(_host_rung(r))
                    fs.crashpoint("sha_after_rung_before_snapshot")
                    _write_snapshot(checkpoint, r + 1, seed, host_copy(bufs["lh"][nxt]),
                                    tree_map(host_copy, bufs["st"][nxt]),
                                    per_rung_host)
                    fs.crashpoint("sha_after_snapshot_before_next_rung")
            fetched = per_rung_host if checkpoint is not None else per_rung_host + [
                _host_rung(r) for r in range(start, n_rungs)]
            state = tree_map(torch.clone, bufs["st"][n_rungs - 1])
            log_h_np = host_copy(bufs["lh"][n_rungs - 1])
        else:  # a finished snapshot: the result with no device work
            fetched = per_rung_host
            state = state0
            log_h_np = host_copy(log_h0)
        sched = [{"n": P0 // eta**r, "steps": int(steps_per_rung) * eta**r}
                 for r in range(n_rungs)]

        def rung_best(losses_np, order_np):
            cand = losses_np[order_np[:, 0]]
            return float(np.min(np.where(np.isfinite(cand), cand, np.inf)))

        rungs = [{**s, "best_loss": rung_best(l, o)} for s, (l, o) in zip(sched, fetched)]
        last_losses, last_order = fetched[-1]
        rep_best_idx = last_order[:, 0]
        rep_bests = last_losses[rep_best_idx]
        r_win = int(np.argmin(np.where(np.isfinite(rep_bests), rep_bests, np.inf)))
        best_i = int(rep_best_idx[r_win])
        return {
            "best_loss": float(last_losses[best_i]),
            "best_hypers": {n: float(np.exp(log_h_np[best_i, i])) for i, n in enumerate(names)},
            "rungs": rungs,
            "state": state,
            "best_index": best_i,
            "replica_bests": [float(b) for b in rep_bests],
        }

    def runner(seed=0, checkpoint=None):
        return _run(seed, checkpoint, eager=False)

    # the same ladder with every rung run eagerly (the card's captured
    # rungs are held against it), the captured rungs, and one rung
    runner._run = _run
    runner._graphs = graphs
    runner._rung_step = lambda r: play_rung(r, False)
    runner._ladder = list(ladder)
    runner._rung_meshes = rung_meshes
    return runner


def compile_hyperband(
    train_fn,
    init_state_fn,
    hyper_bounds,
    s_max,
    eta=2,
    steps_per_rung=5,
    replicas=1,
    mesh=None,
    trial_axis="trial",
    device=None,
    fs=None,
):
    """Hyperband over training on ``device``: every bracket from the most
    exploratory (``eta**s_max`` configs) to a single full-budget one, as
    chained :func:`compile_sha` ladders (the reference's
    :func:`hyperopt_tpu.hyperband.compile_hyperband`).  Bracket ``s`` runs
    ``eta**s`` configs through ``s + 1`` rungs at a base budget of
    ``steps_per_rung * eta**(s_max - s)`` steps.  ``init_state_fn(key,
    n)`` builds a bracket's population lazily at every run, from the
    bracket id folded with the runner's seed.

    Returns ``runner(seed=0, checkpoint=None) -> {"best_loss",
    "best_hypers", "brackets": [...], "best_bracket"}``; ``checkpoint`` (a
    directory) holds one rung-boundary snapshot per bracket
    (``bracket_<s>.npz``, through the file seam ``fs``), so a killed
    spread resumes bitwise.  ``mesh`` and ``trial_axis`` go to every
    bracket's :func:`compile_sha`, as in the reference."""
    if s_max < 0:
        raise ValueError(f"s_max={s_max} must be >= 0")
    dev = resolve_device(device)
    bracket_runners = []
    for s in range(int(s_max), -1, -1):
        n_s = eta**s
        bracket_runners.append((s, compile_sha(
            train_fn,
            # lazy: a bracket's population exists while its ladder runs;
            # the seed folds into the bracket's key
            (lambda seed_, s_=s, n_=n_s: init_state_fn(
                R.fold_in(R.key(s_, device=dev), seed_ % 2**31), int(replicas) * n_)),
            hyper_bounds,
            n_configs=n_s,
            eta=eta,
            steps_per_rung=int(steps_per_rung) * eta ** (int(s_max) - s),
            replicas=replicas,
            mesh=mesh,
            trial_axis=trial_axis,
            device=dev,
            fs=fs,
        )))

    def runner(seed=0, checkpoint=None):
        if checkpoint is not None:
            os.makedirs(checkpoint, exist_ok=True)
        brackets = []
        outs = []
        for s, run_s in bracket_runners:
            out = run_s(
                seed=(int(seed) * 1_000_003 + s) % 2**31,
                checkpoint=None if checkpoint is None else os.path.join(
                    checkpoint, f"bracket_{s}.npz"),
            )
            outs.append(out)
            brackets.append({
                "s": s,
                "n_configs": eta**s,
                "rungs": out["rungs"],
                "best_loss": out["best_loss"],
                "replica_bests": out["replica_bests"],
            })
        # a diverged bracket (non-finite best) never wins
        keyed = [b["best_loss"] if np.isfinite(b["best_loss"]) else np.inf for b in brackets]
        win = int(np.argmin(keyed))
        return {"best_loss": outs[win]["best_loss"], "best_hypers": outs[win]["best_hypers"],
                "brackets": brackets, "best_bracket": win}

    runner._brackets = bracket_runners
    return runner


def asha(
    fn,
    space,
    max_budget,
    eta=3,
    min_budget=1,
    max_jobs=81,
    workers=4,
    algo=None,
    trials=None,
    rstate=None,
    checkpoint=None,
    checkpoint_every=1,
    evaluator=None,
    device=None,
):
    """Asynchronous successive halving (ASHA, Li et al., 2020), the
    reference's :func:`hyperopt_tpu.hyperband.asha`: a configuration is
    promoted the moment it is in the top ``1/eta`` of the completed
    results at its rung, else a fresh rung-0 configuration starts, so
    ``workers`` threads never wait.  The scheduler state sits under one
    lock; rung-0 configs are asked one at a time through ``algo``
    (default: host random search).  ``max_jobs`` bounds the recorded
    evaluations.  ``checkpoint`` snapshots the scheduler every
    ``checkpoint_every`` records and resumes from it (bitwise with
    ``workers=1``); ``evaluator(vals, cfg, budget) -> loss`` replaces the
    inline ``fn(cfg, budget)`` call.  ``device`` is the domain's.

    Returns ``{"best": config, "best_loss", "rungs": [{"budget", "n"}],
    "trials"}``: the best evaluation at the highest budget reached.
    """
    import bisect
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from .base import JOB_STATE_DONE, Domain, Trials
    from .fmin import space_eval

    if rstate is None:
        rstate = np.random.default_rng()
    algo = _default_algo(algo)
    if trials is None:
        trials = Trials()
    n_rungs = _int_log(max_budget / min_budget, eta) + 1
    integral = _budgets_integral(max_budget, min_budget)
    if evaluator is not None:
        _check_evaluator_arity(evaluator)

    def rung_budget(r):
        return _rung_budget(min_budget, eta, r, integral)

    domain = Domain(fn, space, pass_expr_memo_ctrl=False, device=device)
    lock = threading.Lock()
    # rung r -> sorted [(loss, config_key)]: the promotable scan needs no sort
    done = [[] for _ in range(n_rungs)]
    promoted = [set() for _ in range(n_rungs)]  # claims at assignment time
    configs = {}  # config_key -> index-form vals
    pending = {}  # config_key -> suggested doc, completed by its rung-0 record
    started = 0
    recorded = 0  # completed records, failed ones included
    # claims at record time: the snapshot keeps these, so a claim whose
    # evaluation died in flight runs again after a resume
    attempted = [set() for _ in range(n_rungs)]
    if checkpoint is not None:
        if int(checkpoint_every) < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every!r}")
        ckpt_guard = (
            "asha", n_rungs, float(max_budget), float(min_budget), float(eta), int(max_jobs),
            type(rstate.bit_generator).__name__, _algo_identity(algo), _algo_identity(fn),
            _space_fingerprint(domain.expr),
        )
    requeue = []  # restored in-flight rung-0 keys, assigned first

    def _write_ckpt():
        """Snapshot the scheduler (under the lock)."""
        from .utils.checkpoint import save_trials

        save_trials({
            "guard": ckpt_guard,
            "configs": configs,
            "done": done,
            "attempted": [sorted(s) for s in attempted],
            "pending": pending,
            "recorded": recorded,
            "rstate": rstate.bit_generator.state,
            "trials": trials,
        }, checkpoint)

    if checkpoint is not None and os.path.exists(checkpoint):
        from .utils.checkpoint import load_guarded

        snap = load_guarded(checkpoint, ckpt_guard)
        configs = snap["configs"]
        done = snap["done"]
        promoted = [set(s) for s in snap["attempted"]]
        attempted = [set(s) for s in snap["attempted"]]
        pending = snap["pending"]
        requeue = sorted(pending)
        recorded = snap["recorded"]
        started = recorded  # assignments in flight at the kill run again
        # a fresh generator of the guarded type: the caller's is untouched
        rstate = np.random.Generator(type(rstate.bit_generator)())
        rstate.bit_generator.state = snap["rstate"]
        trials = snap["trials"]

    def _suggest_one():
        """One new rung-0 config through the algo seam; its doc is kept
        and completed by the rung-0 record under the same tid."""
        seed = int(rstate.integers(0, 2**31 - 1))
        (tid,) = trials.new_trial_ids(1)
        (doc,) = algo([tid], domain, trials, seed)
        return doc

    def _next_job():
        """Under the lock: the highest-rung eligible promotion, else a
        fresh rung-0 config."""
        nonlocal started
        if started >= max_jobs:
            return None
        if requeue:
            key = requeue.pop(0)
            started += 1
            return key, 0
        for r in range(n_rungs - 2, -1, -1):
            n_promotable = len(done[r]) // eta
            for loss, key in done[r][:n_promotable]:
                if key not in promoted[r]:
                    promoted[r].add(key)
                    started += 1
                    return key, r + 1
        key = len(configs)
        doc = _suggest_one()
        configs[key] = _vals_of(doc)
        pending[key] = doc
        started += 1
        return key, 0

    def _record(key, r, loss):
        nonlocal recorded
        b = rung_budget(r)
        result = {"status": "ok", "loss": float(loss) if np.isfinite(loss) else None,
                  "budget": b}
        if result["loss"] is None:
            result["status"] = "fail"
        doc = pending.pop(key, None)
        if doc is not None:
            doc["result"] = result  # rung 0 completes the suggested doc
        else:
            # a promotion appends a new trial per (config, budget)
            (tid,) = trials.new_trial_ids(1)
            misc = {
                "tid": tid,
                "cmd": ("domain_attachment", "FMinIter_Domain"),
                "workdir": None,
                "idxs": {k: [tid] for k in configs[key]},
                "vals": {k: [v] for k, v in configs[key].items()},
            }
            (doc,) = trials.new_trial_docs([tid], [None], [result], [misc])
        doc["state"] = JOB_STATE_DONE
        trials.insert_trial_docs([doc])
        # refreshed under the lock: a model-based rung-0 algo sees every
        # completed evaluation
        trials.refresh()
        if np.isfinite(loss):
            bisect.insort(done[r], (float(loss), key))
        if r > 0:
            attempted[r - 1].add(key)
        recorded += 1
        if checkpoint is not None and recorded % int(checkpoint_every) == 0:
            _write_ckpt()

    def worker():
        while True:
            with lock:
                job = _next_job()
            if job is None:
                return
            key, r = job
            # decoded OUTSIDE the failure-tolerant region: a space bug
            # surfaces at the first job
            cfg = space_eval(space, configs[key])
            try:
                if evaluator is not None:
                    loss = evaluator(dict(configs[key]), cfg, rung_budget(r))
                else:
                    loss = fn(cfg, rung_budget(r))
                if isinstance(loss, dict):
                    loss = loss["loss"]
                loss = float(loss)
            except Exception:
                logger.exception("asha evaluation failed")
                loss = float("nan")
            with lock:
                _record(key, r, loss)

    with ThreadPoolExecutor(max_workers=int(workers)) as pool:
        futures = [pool.submit(worker) for _ in range(int(workers))]
        for f in futures:
            f.result()  # surface worker crashes
    trials.refresh()
    if checkpoint is not None:
        with lock:
            _write_ckpt()  # the final state, whatever the cadence left

    populated = [r for r in range(n_rungs) if done[r]]
    if not populated:
        from .exceptions import AllTrialsFailed

        raise AllTrialsFailed(
            f"every asha evaluation failed ({max_jobs} jobs, all non-finite or raising); the "
            "recorded trials are in the trials= store if one was passed"
        )
    best_loss, best_key = done[populated[-1]][0]
    return {
        "best": space_eval(space, configs[best_key]),
        "best_loss": best_loss,
        "rungs": [{"budget": rung_budget(r), "n": len(done[r])} for r in range(n_rungs)],
        "trials": trials,
    }


def _space_fingerprint(expr):
    """Stable structural hash of a pyll space graph: distributions, bounds,
    labels and the order of choice options change it; process identity
    does not.  Literal values that are not plain data hash by their type
    name (their place in the graph still counts)."""

    def norm(v):
        if isinstance(v, (str, int, float, bool, type(None))):
            return repr(v)
        if isinstance(v, np.generic):
            return f"np.{type(v).__name__}({v!r})"
        if isinstance(v, np.ndarray):
            if v.dtype == object:
                return f"nd.object{norm(v.tolist())}"
            digest = hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            return f"nd({v.dtype},{v.shape},{digest})"
        if isinstance(v, (list, tuple)):
            return f"{type(v).__name__}({','.join(norm(x) for x in v)})"
        if isinstance(v, dict):
            items = ",".join(f"{norm(k)}:{norm(v[k])}" for k in sorted(v, key=repr))
            return f"dict({items})"
        return f"<{type(v).__module__}.{type(v).__qualname__}>"

    parts = []
    for node in dfs(expr):
        if isinstance(node, Literal):
            parts.append(f"L:{norm(node.obj)}")
        else:
            kw = ",".join(sorted(k for k, _ in node.named_args))
            parts.append(f"A:{node.name}/{len(node.pos_args)}/{kw}")
    return hashlib.sha256("|".join(parts).encode()).hexdigest()
