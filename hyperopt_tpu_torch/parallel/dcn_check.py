"""Multi-process check of the rank-sharded suggest step.

The counterpart of :mod:`hyperopt_tpu.parallel.dcn_check`, stages A and
B: the candidate sweep of :func:`~.sharded.sharded_suggest` spans real
process boundaries.  Run one worker per rank::

    python -m hyperopt_tpu_torch.parallel.dcn_check <rank> <world> <init>
        [--device cpu|cuda] [--batch B] [--n-per-rank N]

``init`` is ``file://<path>`` (a ``FileStore``) or ``host:port``.  Each
rank joins one process group (:func:`.multihost.initialize`: ``gloo``,
unless every rank has a card of its own), builds the same seeded
history and runs the public API over the 1-D ``cand`` mesh of every
rank:

* stage A, ``sharded_suggest`` on a continuous space, twice (the second
  run must repeat the first's bits);
* stage B, the same on a MIXED space, so the categorical sweep's winners
  cross the processes too.

Every step must call ``torch.distributed.all_gather`` exactly once and
no other collective; the ranks must end with the same suggestions (each
rank's ``gmm_llr`` launches are reported beside them).
Rank 0 then checks the winners' distribution against the unsharded
:func:`hyperopt_tpu_torch.tpe.suggest_batch` at equal total candidates
(a two-sample KS distance per dim) and prints ``DCN VALUES`` (its
suggestions, as JSON) and the ``DCN RESULT`` line.  The reference's
stages C-E (a sharded ``compile_fmin``, ``compile_sha`` and
``compile_pbt`` across processes) are ROADMAP item 15c.

:func:`launch` spawns the ranks and returns rank 0's output.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

# the two-sample KS distance allowed at 256 draws a side: the critical
# value at alpha=0.001 is ~0.172 there; 0.2 allows float32 jitter while
# failing any real divergence.  It scales as 1/sqrt(n) at other sizes.
KS_LIMIT_256 = 0.2
# the sweep width of the reference's check
DEFAULT_BATCH, DEFAULT_N_PER_RANK = 256, 32
SEED_A, SEED_B = 5, 11
CONT_LABELS, MIXED_LABELS = ("x", "y"), ("x", "k", "r")


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


def run_stages(device, batch, n_per_rank, mesh, counter=None):
    """Stages A (twice) and B over ``mesh``: the suggested values by
    stage, the histories, and each step's collective counts."""
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

    domain, trials = seeded_history(device=device)
    a = doc_values(ask(domain, trials, SEED_A), CONT_LABELS)
    again = doc_values(ask(domain, trials, SEED_A), CONT_LABELS)
    domain_m, trials_m = seeded_history_mixed(device=device)
    b = doc_values(ask(domain_m, trials_m, SEED_B), MIXED_LABELS)
    return {"A": a, "A_again": again, "B": b}, (domain, trials, domain_m, trials_m), steps


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="python -m hyperopt_tpu_torch.parallel.dcn_check")
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("init")
    p.add_argument("--device", default=None, help="cpu or cuda (default: the card)")
    p.add_argument("--batch", type=int, default=DEFAULT_BATCH)
    p.add_argument("--n-per-rank", type=int, default=DEFAULT_N_PER_RANK)
    args = p.parse_args(argv)

    import torch.distributed as dist

    from ..ops.gmm_scores import KERNEL
    from ..utils import resolve_device
    from . import multihost
    from .mesh import CAND_AXIS, default_mesh
    from .sharded import _default_n_EI_cat_total

    device = resolve_device(args.device)
    assert multihost.initialize(args.init, num_processes=args.world, process_id=args.rank)
    try:
        assert multihost.is_multihost() and multihost.process_count() == args.world
        mesh = default_mesh()  # 1-D cand mesh over every rank
        counter = CollectiveCounter().install()
        try:
            vals, hist, steps = run_stages(device, args.batch, args.n_per_rank, mesh, counter)
        finally:
            counter.uninstall()
        assert all(s == (1, 0) for s in steps), f"collectives per step: {steps}"
        assert vals["A"] == vals["A_again"], "stage A is not deterministic"
        mine = json.dumps(vals, sort_keys=True)
        everyone = [None] * args.world
        dist.all_gather_object(everyone, (mine, KERNEL.launches))
        assert all(v == mine for v, _ in everyone), "the ranks suggested different trials"
        if multihost.process_index() == 0:
            _report(args, vals, hist, steps, mesh.shape[CAND_AXIS], _default_n_EI_cat_total,
                    [n for _, n in everyone])
        else:
            print(f"DCN RESULT rank={args.rank} ok n={args.batch}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _report(args, vals, hist, steps, n_ranks, cat_total, launches):
    """Rank 0's checks against the unsharded path at equal TOTAL
    candidates (local, no collective) and its two output lines;
    ``launches`` are each rank's ``gmm_llr`` launches in its stages."""
    from ..tpe import suggest_batch
    from .mesh import CAND_AXIS
    from .sharded import per_device_count

    domain, trials, domain_m, trials_m = hist
    B, total = args.batch, args.n_per_rank * n_ranks
    limit = ks_limit(B)
    _, un = suggest_batch(trials.new_trial_ids(B), domain, trials, seed=SEED_A + 1,
                          n_EI_candidates=total, n_EI_candidates_cat=None)
    ks = {lab: round(ks_distance(vals["A"][lab], un[lab]), 4) for lab in CONT_LABELS}
    # the sharded path's EXECUTED categorical total: per-rank counts round up
    cat_exec = per_device_count(cat_total, n_ranks) * n_ranks
    _, un_m = suggest_batch(trials_m.new_trial_ids(B), domain_m, trials_m, seed=SEED_B + 1,
                            n_EI_candidates=total, n_EI_candidates_cat=cat_exec)
    ks_m = {lab: round(ks_distance(vals["B"][lab], un_m[lab]), 4) for lab in MIXED_LABELS}
    for lab, v in list(ks.items()) + list(ks_m.items()):
        assert v < limit, (lab, v, limit)
    print("DCN VALUES " + json.dumps({k: vals[k] for k in ("A", "B")}, sort_keys=True),
          flush=True)
    print(f"DCN RESULT procs={args.world} mesh={{{CAND_AXIS}: {n_ranks}}} batch={B} "
          f"n_per_rank={args.n_per_rank} ks={ks} mixed_ks={ks_m} ks_limit={limit:.4f} "
          f"gathers_per_step={[g for g, _ in steps]} launches_by_rank={launches} "
          "deterministic=True ranks_agree=True",
          flush=True)


def launch(world=2, timeout=600, device=None, batch=DEFAULT_BATCH,
           n_per_rank=DEFAULT_N_PER_RANK, workdir=None):
    """Spawn ``world`` ranks (a ``FileStore`` and each rank's log under
    ``workdir``, a fresh temporary directory by default) and return rank
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
    extra = ["--batch", str(batch), "--n-per-rank", str(n_per_rank)]
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
    """Rank 0's ``DCN VALUES`` line as ``{"A": {...}, "B": {...}}``."""
    for line in out.splitlines():
        if line.startswith("DCN VALUES "):
            return json.loads(line[len("DCN VALUES "):])
    raise ValueError("no DCN VALUES line in the output")


if __name__ == "__main__":
    sys.exit(main())
