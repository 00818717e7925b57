"""Multi-process check of the rank-sharded suggest step and of the
populations sharded over processes.

The counterpart of :mod:`hyperopt_tpu.parallel.dcn_check`: the candidate
sweep of :func:`~.sharded.sharded_suggest`, the compiled loop's ``trial``
axis and the population schedulers span real process boundaries.  Run
one worker per rank::

    python -m hyperopt_tpu_torch.parallel.dcn_check <rank> <world> <init>
        [--device cpu|cuda] [--batch B] [--n-per-rank N] [--stages ABCDEFGHIJ]

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
  over the ``trial`` axis, ``cand`` replicating;
* stage I (two ranks), the models' population steps with their data
  axis over the ranks of a ``(1, 2)`` ``trial`` x ``cand`` mesh: TinyLM's
  and ResNet's steps (each rank the gradient half on its half of the
  batch, one ``all_gather`` of the gradients and losses per step, the
  combine and the update half), beside the unsharded step in pairs, and
  ``fmin(resnet.population_objective(..., mesh=), hpo_space(),
  tpe.suggest)`` in every rank (on the card phase 14e's: 30 trials, 20
  of them startup, of 3 steps at batch 128; on the CPU 6, 4 of them
  startup, of 2);
* stage J (four ranks), TinyLM's step on the ``(2, 2)`` mesh: member
  blocks on ``trial``, batch halves on ``cand``.
  Stages I-J run the test files' small sizes on the CPU and full width
  on the card (:data:`DATA_SIZES`).

Every collective is counted inside the ranks (stages A and B: exactly
one ``all_gather`` per step; C-J: the gathers above at each boundary,
and no other collective).  Stages C-J must repeat their bits on the
second run (I's ``fmin`` runs once, its repeat its twin's run in
another process); C-E must be bitwise the unsharded single-process run of the
same program, F-H the same program on a ``virtual_mesh`` of the same
shape, which every rank also runs, and I-J's steps their in-process
twin (:func:`~hyperopt_tpu_torch.models._population.split_twin`, which
every rank runs on its member block), within :data:`DATA_TOL` of the
unsharded step, the ranks of each data line bitwise each other (I's
``fmin`` is held to its twin by the caller: :func:`data_twin_values`);
the ranks must end with the same results (each rank's ``gmm_llr`` launches are reported beside them:
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

import functools
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
STAGES = "ABCDEFGHIJ"
# the reference's stages; F-J are the port's own
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


# stages I-J: the models' population steps with the data axis over the
# ranks.  On the CPU the test files' small sizes, on the card full width:
# TinyLM at bench_pbt's width (pop 32), ResNet-20 x 8 members at batch
# 128 of 32x32x3 (BASELINE #4) and 14e's fmin over its objective
DATA_SHAPES = {"I": (1, 2), "J": (2, 2)}  # trial x cand
DATA_WORLD = {stage: int(np.prod(shape)) for stage, shape in DATA_SHAPES.items()}
DATA_SEED = 21
DATA_SIZES = {
    "cpu": {"tinylm": dict(model=dict(vocab=16, d_model=16, n_heads=2, n_layers=1, max_len=16),
                           pop=4, batch=16, seq=16),
            "resnet": dict(model=dict(stage_sizes=(1, 1, 1), width=8), pop=4, batch=16, image=8),
            "fmin": dict(width=8, image_size=8, batch_size=16, n_steps=2), "trials": 6,
            "startup": 4, "steps": 2},
    "cuda": {"tinylm": dict(model=dict(vocab=32, d_model=32, n_heads=2, n_layers=2, max_len=32),
                            pop=32, batch=32, seq=32),
             "resnet": dict(model=None, pop=8, batch=128, image=32),
             "fmin": dict(width=16, image_size=32, batch_size=128, n_steps=3), "trials": 30,
             "startup": 20, "steps": 3},
}
# the split step against the unsharded step from the same start after the
# run's steps, by device and model: (the max abs difference of the
# parameters and momenta, the max relative difference of the losses).
# A split batch sums in another order.  The CPU's are the model test
# files' PARAM_ATOL and LOSS_RTOL (measured 1.2e-7 and 1.6e-7 for both
# models at the small sizes).  On the card (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md, PR 23) TinyLM's at bench_pbt's width measured 2.4e-7 and
# 1.3e-7.  ResNet-20's measured 5.2e-4 and 1.3e-5 after 3 steps at lr up
# to 0.3 (the same with cuDNN's TF32 off): data_probe finds its first
# step's gradients already 1.3e-4 apart (4.7e-5 of the largest; cuDNN's
# deterministic convolutions sum 64 images in another order than 128)
# and the momenta adding that up, the unsharded float32 step itself 1.2e-3
# from its float64 run, and a combine that drops a slice 5.1 away.  Its
# limit 2e-3 lies between the split and the dropped slice
DATA_TOL = {"cpu": {"tinylm": (1e-6, 1e-5), "resnet": (1e-6, 1e-5)},
            "cuda": {"tinylm": (1e-6, 1e-5), "resnet": (2e-3, 1e-4)}}
# the fmin's losses against the unsharded objective at the same configs,
# relative (measured 1.9e-7 on the CPU, 1.9e-6 on the card)
DATA_FMIN_RTOL = {"cpu": 1e-5, "cuda": 1e-4}


def _one_thread_on_cpu(fn):
    """``fn(device, ...)`` on one intra-op thread when ``device`` is the
    CPU: the ranks of stages I-J share one host's cores (``world`` x
    cores threads would oversubscribe it), and their twins must sum as the
    ranks do, so ranks and twins alike compute single-threaded there."""

    @functools.wraps(fn)
    def run(device, *args, **kwargs):
        import torch

        if device.type != "cpu":
            return fn(device, *args, **kwargs)
        prev = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(device, *args, **kwargs)
        finally:
            torch.set_num_threads(prev)

    return run


def data_programs(stage):
    """Stage I's or J's programs, by name."""
    return ("I_tinylm", "I_resnet", "I_fmin") if stage == "I" else ("J_tinylm",)


def data_setup(name, device):
    """A step program's model family, model, full population (its
    members' lr and wd from numpy, the same bits on every device) and
    data batch, at the device's sizes."""
    import torch

    from .. import random as R
    from ..models import resnet as TR, transformer as TT

    sz = DATA_SIZES[device.type]
    kind = name.split("_", 1)[1]
    cfg = sz[kind]
    if kind == "tinylm":
        fam, model = TT, TT.TinyLM(**cfg["model"])
        data = (TT.synthetic_token_batch(R.key(DATA_SEED + 1, device=device), cfg["batch"],
                                         cfg["seq"], cfg["model"]["vocab"], n_deltas=8),)
    else:
        fam = TR
        model = TR.resnet20() if cfg["model"] is None else TR.ResNet(**cfg["model"])
        data = TR.synthetic_cifar_batch(R.key(DATA_SEED + 1, device=device), cfg["batch"],
                                        cfg["image"])
    params = fam.init_population(model, cfg["pop"], R.key(DATA_SEED, device=device),
                                 device=device)

    def hyper(lo, hi):
        grid = np.exp(np.linspace(np.log(lo), np.log(hi), cfg["pop"])).astype(np.float32)
        return torch.from_numpy(grid).to(device)

    return fam, model, params, hyper(0.3, 0.003), hyper(1e-5, 1e-3), data


def _digest(tree):
    """sha256 of a population's bytes, leaf by leaf in name order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(k.encode())
        h.update(tree[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def data_pairs(step, plain, block, data, n_steps, counter=None):
    """``n_steps`` of ``step`` and of the unsharded ``plain`` in pairs from
    the same start (``block``: a member block's ``(params, lr, wd)``),
    each timed by the host clock up to the host read of its losses (the
    read waits for the step's every kernel, enqueued before it): the values
    (each step's losses, the final population's digest and its
    difference from the unsharded run's), the ms per step of each, and
    the collective counts of each ``step``."""
    from ..models._population import zeros_like

    params, lr, wd = block
    runs = {"split": (params, zeros_like(params)), "plain": (params, zeros_like(params))}
    ms, losses, counts = {"split": [], "plain": []}, {"split": [], "plain": []}, []
    for _ in range(int(n_steps)):
        for which, fn in (("split", step), ("plain", plain)):
            p, m = runs[which]
            t0 = time.perf_counter()
            if which == "split" and counter is not None:
                out, c = counter.step(lambda fn=fn, p=p, m=m: fn(p, m, lr, wd, *data))
                counts.append(c)
            else:
                out = fn(p, m, lr, wd, *data)
            losses[which].append(out[2].cpu())
            ms[which].append((time.perf_counter() - t0) * 1e3)
            runs[which] = out[:2]
    (sp, sm), (pp, pm) = runs["split"], runs["plain"]
    diff = max(float((a[k] - b[k]).abs().max()) for a, b in ((sp, pp), (sm, pm)) for k in a)
    rel = max(float(((a - b) / b).abs().max()) for a, b in zip(losses["split"], losses["plain"]))
    values = {"losses": [x.tolist() for x in losses["split"]],
              "digest": _digest({**{f"p.{k}": v for k, v in sp.items()},
                                 **{f"m.{k}": v for k, v in sm.items()}}),
              "max_abs_diff": diff, "loss_rel_diff": rel}
    return values, {k: sum(v) / len(v) for k, v in ms.items()}, counts


def _member_block(full, lr, wd, n_blocks, index):
    """Block ``index`` of ``n_blocks`` of a population and its hypers."""
    w = lr.shape[0] // n_blocks
    cut = slice(index * w, (index + 1) * w)
    return {k: v[cut] for k, v in full.items()}, lr[cut], wd[cut]


def data_fmin(device, mesh=None, twin=None):
    """Stage I's ``fmin(resnet.population_objective(..., mesh=),
    hpo_space(), tpe.suggest)`` at the device's sizes (``twin``: the
    objective on ``split_twin(step, twin)`` in this process): the trials'
    configs and losses and the ``gmm_llr`` launches of the run."""

    from .. import tpe
    from ..base import Trials
    from ..fmin import fmin
    from ..models import _population as TP, resnet as TR
    from ..ops.gmm_scores import KERNEL

    sz = DATA_SIZES[device.type]
    kw = sz["fmin"]
    wrap = None if twin is None else functools.partial(TP.split_twin, n=twin)
    obj = TR.population_objective(seed=DATA_SEED, mesh=mesh, device=device, wrap_step=wrap,
                                  **kw)
    trials, before = Trials(), KERNEL.launches
    fmin(obj, TR.hpo_space(), algo=functools.partial(tpe.suggest, n_startup_jobs=sz["startup"]),
         max_evals=sz["trials"], trials=trials,
         rstate=np.random.default_rng(DATA_SEED), show_progressbar=False, device=device)
    configs = [{k: float(v[0]) for k, v in t["misc"]["vals"].items()} for t in trials.trials]
    return {"losses": [float(x) for x in trials.losses()], "configs": configs,
            "best_loss": float(min(trials.losses()))}, KERNEL.launches - before


@_one_thread_on_cpu
def data_unsharded_diff(device, values):
    """The unsharded ``population_objective`` at stage I's ``fmin`` configs
    (the ranks' own): the max relative difference of its losses from the
    ranks'."""
    from ..models import resnet as TR

    obj = TR.population_objective(seed=DATA_SEED, device=device,
                                  **DATA_SIZES[device.type]["fmin"])
    return max(abs(obj(cfg) - loss) / abs(loss)
               for cfg, loss in zip(values["configs"], values["losses"]))


@_one_thread_on_cpu
def data_twin_values(device, stages="IJ"):
    """Stages I-J (those in ``stages``) in this one process, each rank's
    split step as :func:`~hyperopt_tpu_torch.models._population.
    split_twin` runs it, member block by member block: what the ranks must
    give, bit for bit, by program name (each step program a list of its
    blocks' values)."""
    from ..models import _population as TP

    out = {}
    for stage in "IJ":
        if stage not in stages:
            continue
        n_trial, n_data = DATA_SHAPES[stage]
        for name in data_programs(stage):
            if name == "I_fmin":
                out[name] = data_fmin(device, twin=n_data)[0]
                continue
            fam, model, full, lr, wd, data = data_setup(name, device)
            plain = fam.make_population_train_step(model, device=device)
            out[name] = [data_pairs(TP.split_twin(plain, n_data), plain,
                                    _member_block(full, lr, wd, n_trial, b), data,
                                    DATA_SIZES[device.type]["steps"])[0]
                         for b in range(n_trial)]
    return out


def _dropped_slices(step, n):
    """``split_twin(step, n)`` with a broken combine that keeps slice 0's
    gradients and losses and drops the other slices: the fault the
    tolerances of :data:`DATA_TOL` must reject."""

    def faulty(pop_params, pop_momentum, lr, wd, *data):
        rows = data[0].shape[0] // n
        grads, losses = step.grad_half(pop_params, *(d[:rows] for d in data))
        return (*step.update_half(pop_params, pop_momentum, grads, lr, wd), losses)

    return faulty


def _final_state(step, params, lr, wd, data, n_steps):
    """The params and momenta after ``n_steps`` of ``step`` from zero
    momenta, by ``p.``/``m.`` name."""
    from ..models._population import zeros_like

    momentum = zeros_like(params)
    for _ in range(int(n_steps)):
        params, momentum, _ = step(params, momentum, lr, wd, *data)
    return {**{f"p.{k}": v for k, v in params.items()},
            **{f"m.{k}": v for k, v in momentum.items()}}


def _max_abs_diff(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)


@_one_thread_on_cpu
def data_probe(device, name="I_resnet"):
    """Where a step program of stage I differs from its unsharded step, on
    the whole population at the device's sizes: ``grad0``, the max abs
    difference of the first step's combined slice gradients from the
    whole batch's gradients (no update between them: the order of the
    convolutions' and reductions' sums alone), beside ``grad0_scale``, the
    largest gradient; ``split``, the split step's max abs difference of
    params and momenta from the unsharded step's after the run's steps
    (what :data:`DATA_TOL` bounds); ``fault``, the same of a combine that
    keeps one slice and drops the rest; ``f32_from_f64`` and
    ``split_from_f64``, the unsharded and the split float32 steps' max abs
    difference from the unsharded step run in float64 from the same
    start."""
    import torch

    from ..models import _population as TP

    fam, model, full, lr, wd, data = data_setup(name, device)
    n, steps = DATA_SHAPES["I"][1], DATA_SIZES[device.type]["steps"]
    plain = fam.make_population_train_step(model, device=device)
    whole = plain.grad_half(full, *data)[0]
    rows = data[0].shape[0] // n
    halves = [plain.grad_half(full, *(d[i * rows:(i + 1) * rows] for d in data))[0]
              for i in range(n)]
    combined = {k: TP.combine_slices(torch.stack([h[k] for h in halves])) for k in whole}
    unsharded = _final_state(plain, full, lr, wd, data, steps)
    split = _final_state(TP.split_twin(plain, n), full, lr, wd, data, steps)
    fault = _final_state(_dropped_slices(plain, n), full, lr, wd, data, steps)
    as64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    f64 = _final_state(plain, {k: v.double() for k, v in full.items()}, lr.double(),
                       wd.double(), tuple(map(as64, data)), steps)
    return {"grad0": _max_abs_diff(combined, whole),
            "grad0_scale": max(float(v.abs().max()) for v in whole.values()),
            "split": _max_abs_diff(split, unsharded), "fault": _max_abs_diff(fault, unsharded),
            "f32_from_f64": _max_abs_diff(unsharded, f64),
            "split_from_f64": _max_abs_diff(split, f64)}


@_one_thread_on_cpu
def run_data_stages(device, world, stages, counter, seconds=None):
    """Stages I-J (those in ``stages``) over the ranks: each step program
    run twice, beside its unsharded step in pairs and against its
    in-process twin on the rank's member block, and I's ``fmin`` once (its
    twin in the caller's process holds it); the values
    (each step program's by member block, exchanged between the ranks and
    the ranks of each data line checked bitwise each other), each run's
    collective counts, the ``fmin``'s ``gmm_llr`` launches, and the ms per
    step of the second run (split and unsharded) or per trial."""
    import torch.distributed as dist

    from ..models import _population as TP
    from .mesh import CAND_AXIS, TRIAL_AXIS, mesh_from_spec, process_index

    vals, counts, launches, step_ms = {}, {}, {}, {}
    for stage in "IJ":
        if stage not in stages:
            continue
        if world != DATA_WORLD[stage]:
            raise ValueError(f"stage {stage} runs on {DATA_WORLD[stage]} ranks, not {world}")
        t0 = time.perf_counter()
        n_trial, n_data = DATA_SHAPES[stage]
        mesh = mesh_from_spec((n_trial, n_data), (TRIAL_AXIS, CAND_AXIS))
        rank = process_index()
        block_of = [mesh.axis_index(TRIAL_AXIS, r) for r in mesh.ranks]
        for name in data_programs(stage):
            runs = []
            if name == "I_fmin":
                # run once: the caller holds it bitwise to its twin, which
                # another process computes (data_twin_values)
                t_run = time.perf_counter()
                (vals[name], launches[name]), c = counter.step(lambda: data_fmin(device, mesh))
                step_ms[name] = ((time.perf_counter() - t_run) * 1e3  # per trial
                                 / DATA_SIZES[device.type]["trials"])
                counts[name] = [c]
                continue
            fam, model, full, lr, wd, data = data_setup(name, device)
            block = _member_block(full, lr, wd, n_trial, block_of[rank])
            step = fam.make_population_train_step(model, mesh=mesh, device=device)
            plain = fam.make_population_train_step(model, device=device)
            for _ in range(2):
                out, ms, c = data_pairs(step, plain, block, data,
                                        DATA_SIZES[device.type]["steps"], counter)
                runs.append(out)
                counts.setdefault(name, []).append(tuple(map(sum, zip(*c))))
                step_ms[f"{name}.split"], step_ms[f"{name}.plain"] = ms["split"], ms["plain"]
            twin = data_pairs(TP.split_twin(plain, n_data), plain, block, data,
                              DATA_SIZES[device.type]["steps"])[0]
            assert runs[0] == runs[1], f"{name} is not deterministic across processes"
            assert runs[0] == twin, f"{name} differs from its in-process twin"
            atol, rtol = DATA_TOL[device.type][name.split("_", 1)[1]]
            assert runs[0]["max_abs_diff"] <= atol, (name, runs[0], atol)
            assert runs[0]["loss_rel_diff"] <= rtol, (name, runs[0], rtol)
            everyone = [None] * world
            dist.all_gather_object(everyone, runs[0])
            blocks = [None] * n_trial
            for r, v in zip(mesh.ranks, everyone):
                b = block_of[r]
                assert blocks[b] is None or blocks[b] == v, f"{name}: a data line disagrees"
                blocks[b] = v
            vals[name] = blocks
        if seconds is not None:
            seconds[stage] = time.perf_counter() - t0
    return vals, counts, launches, step_ms


def data_gathers(name, device_type):
    """The gathers of a run of stage I-J's program ``name`` on each rank:
    one per population step (the ``fmin``'s: each trial's)."""
    sz = DATA_SIZES[device_type]
    return sz["trials"] * sz["fmin"]["n_steps"] if name == "I_fmin" else sz["steps"]


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
                   help="the stages to run, a subset of ABCDEFGHIJ (H and J: four ranks, I: "
                        "two; default ABCDE, the reference's)")
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
            data_vals, data_counts, data_launches, data_ms = run_data_stages(
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
        for name, runs in data_counts.items():
            want = (data_gathers(name, device.type), 0)
            assert all(c == want for c in runs), f"{name}: collectives {runs}, not {want}"
        vals.update(pop_vals)
        vals.update(mesh_vals)
        vals.update(data_vals)
        mine = json.dumps(vals, sort_keys=True)
        everyone = [None] * args.world
        dist.all_gather_object(everyone, (mine, ab_launches, loop_launches, mesh_launches,
                                          data_launches))
        assert all(v[0] == mine for v in everyone), "the ranks ended with different results"
        if multihost.process_index() == 0:
            _report(args, vals, hist, steps, mesh.size, [v[1] for v in everyone],
                    pop_counts, boundaries, [v[2] for v in everyone], seconds,
                    mesh_counts, {name: [v[3][name] for v in everyone]
                                  for name in mesh_launches}, step_ms,
                    data_counts, {name: [v[4][name] for v in everyone]
                                  for name in data_launches}, data_ms)
        else:
            print(f"DCN RESULT rank={args.rank} ok n={args.batch}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _report(args, vals, hist, steps, n_ranks, launches, pop_counts, boundaries, loop_launches,
            seconds, mesh_counts, mesh_launches, step_ms, data_counts, data_launches, data_ms):
    """Rank 0's checks of stages A and B against the unsharded path at
    equal TOTAL candidates (local, no collective) and its two output
    lines; ``launches`` are each rank's ``gmm_llr`` launches in stages A
    and B, ``loop_launches`` in stage C, ``mesh_launches`` in each loop of
    stages F-H and ``data_launches`` in I's ``fmin`` (by program, by
    rank), ``seconds`` rank 0's wall per stage, ``step_ms`` its ms per
    step of each program of F-H and ``data_ms`` of I-J (split and
    unsharded, or per trial)."""
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
    if data_counts:
        diffs = {name: max(b["max_abs_diff"] for b in vals[name])
                 for name in data_counts if name != "I_fmin"}
        rels = {name: max(b["loss_rel_diff"] for b in vals[name])
                for name in data_counts if name != "I_fmin"}
        ran = {st: DATA_SHAPES[st] for st in "IJ" if f"{st}_tinylm" in vals}
        gathers = {name: runs[0][0] for name, runs in data_counts.items()}
        fields.append(f"data_axis={ran} data_gathers={gathers} "
                      f"data_max_abs_diff={diffs} data_loss_rel_diff={rels} "
                      f"data_launches_by_rank={data_launches} data_ms={data_ms} "
                      "data_matches_twin=True data_deterministic=True data_lines_agree=True")
        if "I_fmin" in vals:
            fields.append(f"data_fmin_best={vals['I_fmin']['best_loss']:.6f}")
    print("DCN VALUES " + json.dumps({k: v for k, v in vals.items() if k != "A_again"},
                                     sort_keys=True), flush=True)
    walls = {st: round(t, 3) for st, t in seconds.items()}
    fields.append(f"stage_seconds={walls}")
    print("DCN RESULT " + " ".join(fields) + " ranks_agree=True", flush=True)


def launch(world=2, timeout=600, device=None, batch=DEFAULT_BATCH,
           n_per_rank=DEFAULT_N_PER_RANK, workdir=None, stages=DEFAULT_STAGES):
    """Spawn ``world`` ranks (a ``FileStore`` and each rank's log under
    ``workdir``, a fresh temporary directory by default) running the
    ``stages`` (a subset of ``"ABCDEFGHIJ"``, by default the reference's
    ``"ABCDE"``; stages H and J need four ranks, I two) and return rank
    0's output.

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
