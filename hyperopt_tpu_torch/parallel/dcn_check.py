"""Multi-process check of the rank-sharded suggest step and of the
populations sharded over processes.

The counterpart of :mod:`hyperopt_tpu.parallel.dcn_check`: the candidate
sweep of :func:`~.sharded.sharded_suggest`, the compiled loop's ``trial``
axis and the population schedulers span real process boundaries.  Run
one worker per rank::

    python -m hyperopt_tpu_torch.parallel.dcn_check <rank> <world> <init>
        [--device cpu|cuda] [--batch B] [--n-per-rank N] [--stages ABCDEFGH]

``init`` is ``file://<path>`` (a ``FileStore``) or ``host:port``.  Each
rank joins one process group (:func:`.multihost.initialize`: ``gloo``,
unless every rank has a card of its own), builds the same seeded
history and runs the public API over the 1-D mesh of every rank:

* stage A, ``sharded_suggest`` on a continuous space over the ``cand``
  axis, twice (the second run must repeat the first's bits);
* stage B, the same on a MIXED space, so the categorical sweep's winners
  cross the processes too;
* stage C, ``compile_fmin`` with its ``trial`` axis over the ranks: 64
  evaluations at ``batch_size = world`` of the reference's elementwise
  objective, run twice; each rank evaluates its column of every batch,
  one ``all_gather`` of the losses per step;
* stage D, ``compile_sha`` over the ``trial`` axis (``n_configs =
  world``, ``eta=2``, 2 steps per rung) on the reference's elementwise
  ``train_fn``: one ``all_gather`` of the losses and one of the member
  states per rung;
* stage E, ``compile_pbt`` over the ``trial`` axis (``pop = world``,
  ``exploit_every=2``, 4 rounds) on the same ``train_fn``: one
  ``all_gather`` of the losses and one of the states per exploit;
* stage F, ``compile_fmin`` over the ``cand`` axis of every rank on the
  mixed space, B=1, 64 evaluations, TPE and then ATPE: each model step
  is two graphs with one ``all_gather`` of the packed winners between
  them (the 20 startup steps none);
* stage G, ``compile_fmin(asha=)`` over the ``trial`` axis on an
  elementwise trainable (3 brackets of 8, ``eta=2``, 3 rungs, TPE): one
  ``all_gather`` of the block losses and one of the block states per
  rung;
* stage H (four ranks), the ``trial`` 2 x ``cand`` 2 mesh: stage F's
  ``compile_fmin`` at B=2 (a model step gathers on the rank's ``cand``
  line and then on its ``trial`` line, a startup step on its ``trial``
  line), then ``compile_sha`` (4 configs) and ``compile_pbt`` (pop 4)
  over the ``trial`` axis, ``cand`` replicating.

Every collective is counted inside the ranks (stages A and B: exactly
one ``all_gather`` per step; C-H: the gathers above at each boundary,
and no other collective).  Stages C-H must repeat their bits on the
second run; C-E must be bitwise the unsharded single-process run of the
same program and F-H the same program on a ``virtual_mesh`` of the same
shape, which every rank also runs; the ranks must end with the same
results (each rank's ``gmm_llr`` launches are reported beside them:
stages A and B counted by the kernel's wrapper, the compiled loops of
stages C, F, G and H as each program's captured launches times its
replays).  Rank 0 then checks
stage A and B's winners against the unsharded
:func:`hyperopt_tpu_torch.tpe.suggest_batch` at equal total candidates
(a two-sample KS distance per dim) and prints ``DCN VALUES`` (every
stage's results, as JSON) and the ``DCN RESULT`` line.

:func:`launch` spawns the ranks and returns rank 0's output.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# the two-sample KS distance allowed at 256 draws a side: the critical
# value at alpha=0.001 is ~0.172 there; 0.2 allows float32 jitter while
# failing any real divergence.  It scales as 1/sqrt(n) at other sizes.
KS_LIMIT_256 = 0.2
# the sweep width of the reference's check
DEFAULT_BATCH, DEFAULT_N_PER_RANK = 256, 32
SEED_A, SEED_B = 5, 11
CONT_LABELS, MIXED_LABELS = ("x", "y"), ("x", "k", "r")
STAGES = "ABCDEFGH"
# the reference's stages; F-H are the port's own
DEFAULT_STAGES = "ABCDE"
# stages C-E at the reference's sizes (``dcn_check.py:219-353``); each
# population is as wide as the world
LOOP_EVALS = 64
SHA_STEPS_PER_RUNG, PBT_EXPLOIT_EVERY, PBT_ROUNDS = 2, 2, 4
POP_BOUNDS = {"lr": (1e-3, 1.0)}
POP_SEEDS = {"C": 2, "D": 9, "E": 13}
# stage F: the loop's default 20 startup steps, then 44 model steps;
# stage G: 3 brackets of 8 (8 -> 4 -> 2), the first on the prior;
# stage H: four ranks, populations of 4
LOOP_STARTUP = 20
ASHA = {"eta": 2, "rung_epochs": 1, "n_rungs": 3}
ASHA_BATCH, ASHA_EVALS, ASHA_STARTUP = 8, 24, 8
MESH_POP, MESH_WORLD = 4, 4
MESH_SEEDS = {"F": 4, "G": 5, "H": 6}


def _complete_history(space, fn, n_obs, seed, device):
    """Identical completed-trial history on every rank."""
    from .. import rand
    from ..base import JOB_STATE_DONE, Domain, Trials

    domain = Domain(fn, space, device=device)
    trials = Trials()
    docs = rand.suggest(trials.new_trial_ids(n_obs), domain, trials, seed=seed)
    for d in docs:
        cfg = {k: v[0] for k, v in d["misc"]["vals"].items()}
        d["state"] = JOB_STATE_DONE
        d["result"] = {"status": "ok", "loss": float(fn(cfg))}
    trials.insert_trial_docs(docs)
    trials.refresh()
    return domain, trials


def cont_space(hp):
    return {
        "x": hp.uniform("x", -5.0, 5.0),
        "y": hp.loguniform("y", float(np.log(1e-3)), float(np.log(10.0))),
    }


def cont_fn(cfg):
    return (cfg["x"] - 1.0) ** 2 + (np.log(cfg["y"]) + 1.0) ** 2


def mixed_space(hp):
    return {
        "x": hp.uniform("x", -5.0, 5.0),
        "k": hp.choice("k", [0.1, 0.5, 1.0, 2.0, 4.0]),
        "r": hp.randint("r", 4),
    }


def mixed_fn(cfg):
    return (cfg["x"] - 1.0) ** 2 + cfg["k"] + 0.25 * cfg["r"]


def seeded_history(n_obs=40, seed=0, device=None):
    """The continuous history of stage A (the reference's
    ``_seeded_history``)."""
    from .. import hp

    return _complete_history(cont_space(hp), cont_fn, n_obs, seed, device)


def seeded_history_mixed(n_obs=40, seed=0, device=None):
    """The mixed history of stage B (the reference's
    ``_seeded_history_mixed``)."""
    from .. import hp

    return _complete_history(mixed_space(hp), mixed_fn, n_obs, seed, device)


def doc_values(docs, labels):
    """Each label's suggested values, in trial order."""
    return {lab: [d["misc"]["vals"][lab][0] for d in docs] for lab in labels}


def ks_distance(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    grid = np.sort(np.concatenate([a, b]))

    def ecdf(x):
        return np.searchsorted(np.sort(x), grid, side="right") / len(x)

    return float(np.abs(ecdf(a) - ecdf(b)).max())


def ks_limit(n):
    return KS_LIMIT_256 * (256.0 / float(n)) ** 0.5


class CollectiveCounter:
    """Counts the calls of every ``torch.distributed`` collective while
    installed: ``all_gather`` apart, the rest summed."""

    OTHERS = ("all_gather_into_tensor", "all_gather_object", "all_reduce", "broadcast",
              "broadcast_object_list", "reduce", "gather", "scatter", "reduce_scatter",
              "all_to_all", "barrier")

    def __init__(self):
        self.all_gather = 0
        self.others = 0
        self._saved = []

    def install(self):
        import torch.distributed as dist

        def counting(name, real):
            def call(*args, **kw):
                if name == "all_gather":
                    self.all_gather += 1
                else:
                    self.others += 1
                return real(*args, **kw)

            return call

        for name in ("all_gather",) + self.OTHERS:
            real = getattr(dist, name, None)
            if real is not None:
                self._saved.append((name, real))
                setattr(dist, name, counting(name, real))
        return self

    def uninstall(self):
        import torch.distributed as dist

        while self._saved:
            name, real = self._saved.pop()
            setattr(dist, name, real)

    def step(self, run):
        """``run()``'s result and the (all_gather, other) calls it made."""
        g0, o0 = self.all_gather, self.others
        out = run()
        return out, (self.all_gather - g0, self.others - o0)


def run_stages(device, batch, n_per_rank, mesh, counter=None, stages="AB", seconds=None):
    """Stages A (twice) and B over ``mesh``, those of them in ``stages``:
    the suggested values by stage, the histories, and each step's
    collective counts (each stage's wall into ``seconds``)."""
    from .sharded import sharded_suggest

    steps = []

    def ask(domain, trials, seed):
        def run():
            return sharded_suggest(trials.new_trial_ids(batch), domain, trials, seed=seed,
                                   mesh=mesh, n_EI_per_device=n_per_rank)

        if counter is None:
            return run()
        docs, counts = counter.step(run)
        steps.append(counts)
        return docs

    seconds = {} if seconds is None else seconds
    vals, domain, trials, domain_m, trials_m = {}, None, None, None, None
    if "A" in stages:
        domain, trials = seeded_history(device=device)
        t0 = time.perf_counter()
        vals["A"] = doc_values(ask(domain, trials, SEED_A), CONT_LABELS)
        vals["A_again"] = doc_values(ask(domain, trials, SEED_A), CONT_LABELS)
        seconds["A"] = time.perf_counter() - t0
    if "B" in stages:
        domain_m, trials_m = seeded_history_mixed(device=device)
        t0 = time.perf_counter()
        vals["B"] = doc_values(ask(domain_m, trials_m, SEED_B), MIXED_LABELS)
        seconds["B"] = time.perf_counter() - t0
    return vals, (domain, trials, domain_m, trials_m), steps


def loop_fn(cfg):
    """Stage C's objective, the reference's elementwise quadratic."""
    import torch

    return (cfg["x"] - 1.0) ** 2 + (torch.log(cfg["y"]) + 1.0) ** 2


def member_train_fn(state, hypers, key):
    """Stages D and E's ``train_fn``, the reference's: one elementwise
    gradient step of every member on ``(theta - 0.7)**2``."""
    theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7)
    return {"theta": theta}, (theta - 0.7) ** 2


def population_runners(device, width, mesh=None):
    """Stages C, D and E's runners, each population ``width`` wide: over
    ``mesh``'s ``trial`` axis, or unsharded (None)."""
    import torch

    from .. import hp
    from ..device_loop import compile_fmin
    from ..hyperband import compile_sha
    from ..pbt import compile_pbt
    from .mesh import TRIAL_AXIS

    kw = {"device": device} if mesh is None else {"device": device, "mesh": mesh,
                                                  "trial_axis": TRIAL_AXIS}
    init = {"theta": torch.full((width,), 5.0)}
    return {
        "C": compile_fmin(loop_fn, cont_space(hp), max_evals=LOOP_EVALS, batch_size=width,
                          **kw),
        "D": compile_sha(member_train_fn, init, POP_BOUNDS, n_configs=width, eta=2,
                         steps_per_rung=SHA_STEPS_PER_RUNG, **kw),
        "E": compile_pbt(member_train_fn, init, POP_BOUNDS, pop_size=width,
                         exploit_every=PBT_EXPLOIT_EVERY, n_rounds=PBT_ROUNDS, **kw),
    }


def population_boundaries(runners, width):
    """Each stage's boundaries per run: the loop's steps, the ladder's
    rungs, the schedule's exploits."""
    return {"C": -(-LOOP_EVALS // width), "D": len(runners["D"]._ladder), "E": PBT_ROUNDS}


def population_values(stage, out):
    """A stage's result as JSON values (every float exact): the loop's
    history, the ladder's rungs, hypers and final population, the
    schedule's loss history, hypers and final population."""
    if stage == "C":
        return {"losses": out["losses"].tolist(), "values": out["values"].tolist(),
                "best_loss": out["best_loss"]}
    state = out["state"]["theta"].cpu().tolist()
    if stage == "D":
        return {"rungs": out["rungs"], "best_loss": out["best_loss"],
                "best_hypers": out["best_hypers"], "state": state}
    return {"loss_history": out["loss_history"].tolist(), "best_loss": out["best_loss"],
            "hypers": {k: v.tolist() for k, v in out["hypers"].items()}, "state": state}


def unsharded_population(device, width, stages="CDE"):
    """Stages C-E (those in ``stages``) run unsharded in this one process:
    what the ranks must give, bit for bit."""
    runners = population_runners(device, width)
    return {st: population_values(st, runners[st](seed=POP_SEEDS[st]))
            for st in "CDE" if st in stages}


def run_population_stages(device, width, stages, counter, seconds=None):
    """Stages C-E (those in ``stages``) over the ``trial`` axis of every
    rank, twice each, against the unsharded run in this process: the
    values, each run's collective counts, the boundaries per run and the
    loop's ``gmm_llr`` launches (captured launches times replays); each
    stage's wall (its two runs, the first one's capture included) into
    ``seconds``."""
    from .mesh import TRIAL_AXIS, default_mesh

    runners = population_runners(device, width, default_mesh(TRIAL_AXIS))
    want = unsharded_population(device, width, stages)
    vals, counts, loop_launches = {}, {}, 0
    for st in "CDE":
        if st not in stages:
            continue
        runs, t0 = [], time.perf_counter()
        for _ in range(2):
            out, c = counter.step(lambda st=st: runners[st](seed=POP_SEEDS[st]))
            runs.append(population_values(st, out))
            counts.setdefault(st, []).append(c)
            if st == "C":
                loop_launches += compiled_launches(runners["C"])
        if seconds is not None:
            seconds[st] = time.perf_counter() - t0
        assert runs[0] == runs[1], f"stage {st} is not deterministic across processes"
        assert runs[0] == want[st], f"stage {st} differs from the single-process run"
        vals[st] = runs[0]
    return vals, counts, population_boundaries(runners, width), loop_launches


def mixed_loop_fn(cfg):
    """Stage F's objective on :func:`mixed_space` (categorical dims as
    float indices), elementwise."""
    return (cfg["x"] - 1.0) ** 2 + 0.1 * cfg["k"] + 0.25 * cfg["r"]


def asha_space(hp):
    return {"decay": hp.uniform("decay", 0.05, 0.6), "t": hp.uniform("t", -2.0, 2.0)}


def asha_trainable():
    """Stage G's ``TrainableObjective``: each trial's ``theta`` starts
    uniform in [0, 1)^3 and every epoch moves it toward ``t``, elementwise
    float32 (every trial's bits independent of its place in the batch)."""
    from .. import random as R
    from ..device_loop import TrainableObjective

    def init(k, cfg):
        return {"theta": R.uniform(k, (3,))}

    def step(s, cfg, epoch):
        return {"theta": (s["theta"] - cfg["t"]) * (1.0 - cfg["decay"])}

    def loss(s, cfg):
        return s["theta"][0] * s["theta"][0]

    return TrainableObjective(init, step, loss)


def mesh_runners(device, world, stages, real=False):
    """Stages F-H's runners (those in ``stages``), by name: over the
    ranks' meshes (``real``), or the same programs on virtual meshes of
    the same shapes in this process."""
    import torch

    from .. import hp
    from ..device_loop import compile_fmin
    from ..hyperband import compile_sha
    from ..pbt import compile_pbt
    from .mesh import CAND_AXIS, TRIAL_AXIS, default_mesh, mesh_from_spec, virtual_mesh

    out = {}
    if "F" in stages:
        cand = default_mesh(CAND_AXIS) if real else virtual_mesh(world, CAND_AXIS)
        for algo in ("tpe", "atpe"):
            out[f"F_{algo}"] = compile_fmin(mixed_loop_fn, mixed_space(hp), max_evals=LOOP_EVALS,
                                            algo=algo, mesh=cand, cand_axis=CAND_AXIS,
                                            device=device)
    if "G" in stages:
        trial = default_mesh(TRIAL_AXIS) if real else virtual_mesh(world, TRIAL_AXIS)
        out["G"] = compile_fmin(asha_trainable(), asha_space(hp), max_evals=ASHA_EVALS,
                                batch_size=ASHA_BATCH, n_startup_jobs=ASHA_STARTUP,
                                n_EI_candidates=8, asha=ASHA, mesh=trial, trial_axis=TRIAL_AXIS,
                                device=device)
    if "H" in stages:
        axes = (TRIAL_AXIS, CAND_AXIS)
        two = mesh_from_spec((2, 2), axes) if real else virtual_mesh((2, 2), axes)
        kw = {"device": device, "mesh": two, "trial_axis": TRIAL_AXIS}
        init = {"theta": torch.linspace(0.5, 5.0, MESH_POP)}
        out["H_fmin"] = compile_fmin(mixed_loop_fn, mixed_space(hp), max_evals=LOOP_EVALS,
                                     batch_size=2, cand_axis=CAND_AXIS, **kw)
        out["H_sha"] = compile_sha(member_train_fn, init, POP_BOUNDS, n_configs=MESH_POP, eta=2,
                                   steps_per_rung=SHA_STEPS_PER_RUNG, **kw)
        out["H_pbt"] = compile_pbt(member_train_fn, init, POP_BOUNDS, pop_size=MESH_POP,
                                   exploit_every=PBT_EXPLOIT_EVERY, n_rounds=PBT_ROUNDS, **kw)
    return out


def mesh_boundaries(name):
    """The gathers a run of stage F-H's program ``name`` makes on each
    rank: one per model step on the ``cand`` line (stage F); two per
    rung of each bracket (G); on the 2 x 2 mesh two per model step and
    one per startup step, two per rung and two per exploit (H)."""
    n_model = LOOP_EVALS - LOOP_STARTUP
    if name.startswith("F_"):
        return n_model
    if name == "G":
        return 2 * ASHA["n_rungs"] * (ASHA_EVALS // ASHA_BATCH)
    if name == "H_fmin":
        return 2 * (n_model // 2) + LOOP_STARTUP // 2
    if name == "H_sha":
        return 2 * 3  # 4 -> 2 -> 1 configs
    return 2 * PBT_ROUNDS


def mesh_steps(name):
    """The steps of a run of stage F-H's program ``name``: loop steps,
    brackets, rungs or exploit rounds."""
    if name.startswith("F_"):
        return LOOP_EVALS
    if name == "G":
        return ASHA_EVALS // ASHA_BATCH
    if name == "H_fmin":
        return LOOP_EVALS // 2
    return 3 if name == "H_sha" else PBT_ROUNDS


def mesh_values(name, out):
    """A stage F-H result as JSON values (every float exact)."""
    if name.startswith(("F_", "H_fmin")):
        return {"losses": out["losses"].tolist(), "values": out["values"].tolist(),
                "best_loss": out["best_loss"]}
    if name == "G":
        return {"losses": out["losses"].tolist(), "values": out["values"].tolist(),
                "rung_of": out["rung_of"].tolist(), "best_loss": out["best_loss"]}
    return population_values("D" if name == "H_sha" else "E", out)


def mesh_seed(name):
    return MESH_SEEDS[name[0]]


def compiled_launches(runner):
    """A compiled loop's ``gmm_llr`` launches in its last run: each
    regime's captured launches times its replays."""
    prog = runner._program()
    return sum(prog.launches_per_replay.get(r, 0) * n for r, n in prog.replays.items())


def virtual_mesh_values(device, world, stages="FGH"):
    """Stages F-H (those in ``stages``) on virtual meshes in this one
    process: what the ranks must give, bit for bit, by program name."""
    runners = mesh_runners(device, world, stages)
    return {name: mesh_values(name, r(seed=mesh_seed(name))) for name, r in runners.items()}


def run_mesh_stages(device, world, stages, counter, seconds=None):
    """Stages F-H (those in ``stages``) over the ranks, each program run
    twice, against its virtual twin in this process: the values, each
    run's collective counts, the loops' ``gmm_llr`` launches and the ms
    per step of the second run (its graphs captured by the first), by
    program; each stage's wall (its runs, the first one's capture
    included) into ``seconds``."""
    if "H" in stages and world != MESH_WORLD:
        raise ValueError(f"stage H runs on {MESH_WORLD} ranks, not {world}")
    runners = mesh_runners(device, world, stages, real=True)
    want = virtual_mesh_values(device, world, stages)
    vals, counts, launches, step_ms, t0 = {}, {}, {}, {}, {}
    for name, runner in runners.items():
        t0.setdefault(name[0], time.perf_counter())
        runs = []
        for _ in range(2):
            t_run = time.perf_counter()
            out, c = counter.step(lambda r=runner, n=name: r(seed=mesh_seed(n)))
            step_ms[name] = (time.perf_counter() - t_run) * 1e3 / mesh_steps(name)
            runs.append(mesh_values(name, out))
            counts.setdefault(name, []).append(c)
            if not name.startswith(("H_sha", "H_pbt")):
                launches[name] = launches.get(name, 0) + compiled_launches(runner)
        if seconds is not None:
            seconds[name[0]] = time.perf_counter() - t0[name[0]]
        assert runs[0] == runs[1], f"{name} is not deterministic across processes"
        assert runs[0] == want[name], f"{name} differs from its virtual mesh run"
        vals[name] = runs[0]
    return vals, counts, launches, step_ms


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="python -m hyperopt_tpu_torch.parallel.dcn_check")
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("init")
    p.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    p.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    p.add_argument("--n-per-rank", type=int, default=DEFAULT_N_PER_RANK)
    p.add_argument("--stages", default=DEFAULT_STAGES,
                   help="the stages to run, a subset of ABCDEFGH (H: four ranks; default "
                        "ABCDE, the reference's)")
    args = p.parse_args(argv)
    if not args.stages or set(args.stages) - set(STAGES):
        p.error(f"--stages {args.stages!r}: expected a subset of {STAGES}")

    import torch.distributed as dist

    from ..ops.gmm_scores import KERNEL
    from ..utils import resolve_device
    from . import multihost
    from .mesh import default_mesh

    device = resolve_device(args.device)
    assert multihost.initialize(args.init, num_processes=args.world, process_id=args.rank)
    try:
        assert multihost.is_multihost() and multihost.process_count() == args.world
        mesh = default_mesh()  # 1-D cand mesh over every rank
        counter, seconds = CollectiveCounter().install(), {}
        try:
            vals, hist, steps = run_stages(device, args.batch, args.n_per_rank, mesh, counter,
                                           args.stages, seconds)
            ab_launches = KERNEL.launches
            pop_vals, pop_counts, boundaries, loop_launches = run_population_stages(
                device, args.world, args.stages, counter, seconds)
            mesh_vals, mesh_counts, mesh_launches, step_ms = run_mesh_stages(
                device, args.world, args.stages, counter, seconds)
        finally:
            counter.uninstall()
        assert all(s == (1, 0) for s in steps), f"collectives per step: {steps}"
        assert vals.get("A") == vals.get("A_again"), "stage A is not deterministic"
        per_boundary = {"C": 1, "D": 2, "E": 2}  # all_gathers: losses (and states)
        for st, runs in pop_counts.items():
            want = (per_boundary[st] * boundaries[st], 0)
            assert all(c == want for c in runs), f"stage {st}: collectives {runs}, not {want}"
        for name, runs in mesh_counts.items():
            want = (mesh_boundaries(name), 0)
            assert all(c == want for c in runs), f"{name}: collectives {runs}, not {want}"
        vals.update(pop_vals)
        vals.update(mesh_vals)
        mine = json.dumps(vals, sort_keys=True)
        everyone = [None] * args.world
        dist.all_gather_object(everyone, (mine, ab_launches, loop_launches, mesh_launches))
        assert all(v[0] == mine for v in everyone), "the ranks ended with different results"
        if multihost.process_index() == 0:
            _report(args, vals, hist, steps, mesh.size, [v[1] for v in everyone],
                    pop_counts, boundaries, [v[2] for v in everyone], seconds,
                    mesh_counts, {name: [v[3][name] for v in everyone]
                                  for name in mesh_launches}, step_ms)
        else:
            print(f"DCN RESULT rank={args.rank} ok n={args.batch}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _report(args, vals, hist, steps, n_ranks, launches, pop_counts, boundaries, loop_launches,
            seconds, mesh_counts, mesh_launches, step_ms):
    """Rank 0's checks of stages A and B against the unsharded path at
    equal TOTAL candidates (local, no collective) and its two output
    lines; ``launches`` are each rank's ``gmm_llr`` launches in stages A
    and B, ``loop_launches`` in stage C, ``mesh_launches`` in each loop of
    stages F-H (by program, by rank), ``seconds`` rank 0's wall per
    stage and ``step_ms`` its ms per step of each program of F-H."""
    from ..tpe import suggest_batch
    from .mesh import CAND_AXIS
    from .sharded import _default_n_EI_cat_total, per_device_count

    domain, trials, domain_m, trials_m = hist
    B, total = args.batch, args.n_per_rank * n_ranks
    limit = ks_limit(B)
    fields = [f"procs={args.world} stages={args.stages}"]
    if "A" in vals or "B" in vals:
        fields.append(f"mesh={{{CAND_AXIS}: {n_ranks}}} batch={B} n_per_rank={args.n_per_rank}")
    if "A" in vals:
        _, un = suggest_batch(trials.new_trial_ids(B), domain, trials, seed=SEED_A + 1,
                              n_EI_candidates=total, n_EI_candidates_cat=None)
        ks = {lab: round(ks_distance(vals["A"][lab], un[lab]), 4) for lab in CONT_LABELS}
        fields.append(f"ks={ks}")
    if "B" in vals:
        # the sharded path's EXECUTED categorical total: per-rank counts round up
        cat_exec = per_device_count(_default_n_EI_cat_total, n_ranks) * n_ranks
        _, un_m = suggest_batch(trials_m.new_trial_ids(B), domain_m, trials_m,
                                seed=SEED_B + 1, n_EI_candidates=total,
                                n_EI_candidates_cat=cat_exec)
        ks_m = {lab: round(ks_distance(vals["B"][lab], un_m[lab]), 4) for lab in MIXED_LABELS}
        fields.append(f"mixed_ks={ks_m}")
        ks = {**(ks if "A" in vals else {}), **{f"mixed_{k}": v for k, v in ks_m.items()}}
    if "A" in vals or "B" in vals:
        for lab, v in ks.items():
            assert v < limit, (lab, v, limit)
        fields.append(f"ks_limit={limit:.4f} gathers_per_step={[g for g, _ in steps]} "
                      f"launches_by_rank={launches} deterministic=True")
    w = args.world
    if "C" in vals:
        fields.append(f"pop_sharded_loop={{trial: {w}}} best={vals['C']['best_loss']:.5f} "
                      f"loop_deterministic=True loop_matches_unsharded=True "
                      f"loop_launches_by_rank={loop_launches}")
    if "D" in vals:
        fields.append(f"sha_dcn={{trial: {w}, n_configs: {w}}} "
                      f"sha_best={vals['D']['best_loss']:.5f} sha_matches_unsharded=True "
                      "sha_deterministic=True")
    if "E" in vals:
        fields.append(f"pbt_dcn={{trial: {w}, pop: {w}}} pbt_best={vals['E']['best_loss']:.5f} "
                      "pbt_matches_unsharded=True pbt_deterministic=True")
    if pop_counts:
        gathers = {st: runs[0][0] for st, runs in pop_counts.items()}
        ran = {st: boundaries[st] for st in gathers}
        fields.append(f"boundaries={ran} gathers_by_stage={gathers}")
    if "F_tpe" in vals:
        fields.append(f"cand_loop={{cand: {w}}} cand_best={{tpe: "
                      f"{vals['F_tpe']['best_loss']:.5f}, atpe: {vals['F_atpe']['best_loss']:.5f}}} "
                      "cand_matches_virtual=True cand_deterministic=True")
    if "G" in vals:
        fields.append(f"asha_loop={{trial: {w}, batch: {ASHA_BATCH}}} "
                      f"asha_best={vals['G']['best_loss']:.5f} asha_matches_virtual=True "
                      "asha_deterministic=True")
    if "H_fmin" in vals:
        fields.append(f"two_axes={{trial: 2, cand: 2}} two_axes_best={{fmin: "
                      f"{vals['H_fmin']['best_loss']:.5f}, sha: {vals['H_sha']['best_loss']:.5f}, "
                      f"pbt: {vals['H_pbt']['best_loss']:.5f}}} two_axes_matches_virtual=True "
                      "two_axes_deterministic=True")
    if mesh_counts:
        gathers = {name: runs[0][0] for name, runs in mesh_counts.items()}
        fields.append(f"mesh_gathers={gathers} mesh_launches_by_rank={mesh_launches} "
                      f"mesh_ms_per_step={ {k: round(v, 4) for k, v in step_ms.items()} }")
    print("DCN VALUES " + json.dumps({k: v for k, v in vals.items() if k != "A_again"},
                                     sort_keys=True), flush=True)
    walls = {st: round(t, 3) for st, t in seconds.items()}
    fields.append(f"stage_seconds={walls}")
    print("DCN RESULT " + " ".join(fields) + " ranks_agree=True", flush=True)


def launch(world=2, timeout=600, device=None, batch=DEFAULT_BATCH,
           n_per_rank=DEFAULT_N_PER_RANK, workdir=None, stages=DEFAULT_STAGES):
    """Spawn ``world`` ranks (a ``FileStore`` and each rank's log under
    ``workdir``, a fresh temporary directory by default) running the
    ``stages`` (a subset of ``"ABCDEFGH"``, by default the reference's
    ``"ABCDE"``; stage H needs four ranks) and return rank 0's output.

    Raises ``RuntimeError`` with every rank's tail as soon as one exits
    non-zero, or when ``timeout`` seconds pass first; every rank still
    running is killed before it returns."""
    import shutil
    import subprocess
    import tempfile
    import time

    own = workdir is None
    workdir = tempfile.mkdtemp(prefix="dcn_check_") if own else str(workdir)
    store = os.path.join(workdir, "store")
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    extra = ["--batch", str(batch), "--n-per-rank", str(n_per_rank), "--stages", str(stages)]
    if device is not None:
        extra += ["--device", str(device)]
    logs = [os.path.join(workdir, f"rank{r}.log") for r in range(int(world))]
    procs = []
    try:
        for rank, path in enumerate(logs):
            with open(path, "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "hyperopt_tpu_torch.parallel.dcn_check", str(rank),
                     str(world), f"file://{store}"] + extra,
                    env=env, stdout=log, stderr=subprocess.STDOUT,
                ))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:  # never orphan a rank
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for path in logs:
            with open(path) as f:
                outs.append(f.read())
        if own:
            shutil.rmtree(workdir, ignore_errors=True)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"dcn_check: a rank failed or outlived {timeout} s (exit codes "
                           f"{[p.returncode for p in procs]}):\n"
                           + "\n---\n".join(out[-3000:] for out in outs))
    return outs[0]


def parse_values(out):
    """Rank 0's ``DCN VALUES`` line as ``{"A": {...}, "B": {...}, ...}``,
    one entry per stage run."""
    for line in out.splitlines():
        if line.startswith("DCN VALUES "):
            return json.loads(line[len("DCN VALUES "):])
    raise ValueError("no DCN VALUES line in the output")


if __name__ == "__main__":
    sys.exit(main())
