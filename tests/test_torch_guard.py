"""Guards of the PyTorch port: it never imports JAX or the JAX package,
and never falls back to the CPU on its own."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import hyperopt_tpu_torch as H
from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hyperopt_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hyperopt_tpu")


def test_fmin_in_a_fresh_process_loads_no_jax():
    """(a) a 30-trial fmin on the CPU; afterwards neither jax nor the JAX
    package is in sys.modules."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import hyperopt_tpu_torch as H
        from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
        t = H.Trials()
        H.fmin(mixed_space_fn, mixed_space(), max_evals=30, trials=t,
               rstate=np.random.default_rng(0), device="cpu")
        assert len(t.trials) == 30
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hyperopt_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_serve_in_a_fresh_process_loads_no_jax():
    """(a') a 4-study SuggestService on the CPU, three rounds; afterwards
    neither jax nor the JAX package is in sys.modules."""
    code = textwrap.dedent("""
        import sys
        from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
        from hyperopt_tpu_torch.serve import SuggestService
        svc = SuggestService(mixed_space(), max_batch=4, background=False,
                             n_startup_jobs=2, n_cand=16, device="cpu")
        hs = [svc.create_study(f"s{i}", seed=i) for i in range(4)]
        for _ in range(3):
            futs = [h.ask_async() for h in hs]
            svc.pump()
            for h, f in zip(hs, futs):
                tid, vals = f.result(timeout=60)
                h.tell(tid, mixed_space_fn(vals))
        assert svc.counters["dispatch_count"] == 3
        svc.shutdown()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hyperopt_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_compiled_loop_in_a_fresh_process_loads_no_jax(tmp_path):
    """(a'') the compiled loop on the CPU -- a chunked, checkpointed
    ``compile_fmin`` of the tensor objective and a trainable run -- and
    afterwards neither jax nor the JAX package is in sys.modules."""
    code = textwrap.dedent(f"""
        import sys
        from hyperopt_tpu_torch.device_loop import compile_fmin
        from hyperopt_tpu_torch.models.synthetic import (
            mixed_space, mixed_space_fn_torch, mlp_tune_objective, mlp_tune_space)
        out = compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=12,
                           n_startup_jobs=4, n_EI_candidates=8, chunk_size=4,
                           checkpoint_path={str(tmp_path / "c.ckpt")!r}, device="cpu")(seed=0)
        assert out["n_evals"] == 12
        obj = mlp_tune_objective(n_epochs=2, n_train=16, in_dim=2, hidden=4)
        out = compile_fmin(obj, mlp_tune_space(), max_evals=8, batch_size=4,
                           n_startup_jobs=4, n_EI_candidates=4, device="cpu")(seed=0)
        assert out["n_evals"] == 8
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hyperopt_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_source(path):
    """(b) no module of the port and nothing in chip_smoke.py imports jax,
    flax, optax or hyperopt_tpu (absolute imports; relative ones stay in
    the port)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, node.lineno, name)


def test_no_cuda_means_no_silent_cpu(monkeypatch):
    """(c) without CUDA, fmin without device="cpu" raises -- and runs no
    trial on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trials = H.Trials()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H.fmin(mixed_space_fn, mixed_space(), max_evals=3, trials=trials)
    assert len(trials.trials) == 0


def test_no_cuda_means_no_silent_cpu_compiled_loop(monkeypatch):
    """(c') without CUDA, compile_fmin and fmin(compiled=True) raise unless
    the caller passes device="cpu"."""
    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.models.synthetic import mixed_space_fn_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=4)
    trials = H.Trials()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H.fmin(mixed_space_fn_torch, mixed_space(), max_evals=4, trials=trials, compiled=True)
    assert len(trials.trials) == 0
    out = compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=4, n_startup_jobs=2,
                       n_EI_candidates=4, device="cpu")(seed=0)
    assert out["n_evals"] == 4


def test_schedulers_in_a_fresh_process_load_no_jax():
    """(a''') the schedulers on the CPU -- compile_sha with two replicas,
    compile_pbt, compile_fmin(asha=) and the host successive halving --
    and afterwards neither jax nor the JAX package is in sys.modules."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from hyperopt_tpu_torch.device_loop import compile_fmin
        from hyperopt_tpu_torch.hyperband import compile_sha, successive_halving
        from hyperopt_tpu_torch.models.synthetic import (
            budgeted_quadratic_fn, budgeted_quadratic_space, mlp_tune_objective,
            mlp_tune_space)
        from hyperopt_tpu_torch.pbt import compile_pbt

        def train_fn(state, hypers, key):
            theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7)
            return {"theta": theta}, (theta - 0.7) ** 2

        sha = compile_sha(train_fn, {"theta": np.zeros(8, np.float32)}, {"lr": (1e-3, 1.0)},
                          n_configs=4, replicas=2, steps_per_rung=1, device="cpu")(seed=0)
        assert len(sha["rungs"]) == 3
        pbt = compile_pbt(train_fn, {"theta": np.zeros(4, np.float32)}, {"lr": (1e-3, 1.0)},
                          pop_size=4, exploit_every=2, n_rounds=2, device="cpu")(seed=0)
        assert pbt["loss_history"].shape == (2, 4)
        obj = mlp_tune_objective(n_epochs=1, n_train=16, in_dim=2, hidden=4)
        out = compile_fmin(obj, mlp_tune_space(), max_evals=8, batch_size=4,
                           asha={"eta": 2, "n_rungs": 2}, device="cpu")(seed=0)
        assert out["rung_of"].tolist().count(1) == 4
        sh = successive_halving(budgeted_quadratic_fn, budgeted_quadratic_space(),
                                max_budget=9, eta=3, rstate=np.random.default_rng(0),
                                device="cpu")
        assert len(sh["trials"]) == 13
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hyperopt_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_cuda_means_no_silent_cpu_schedulers(monkeypatch):
    """(c'') without CUDA, compile_sha, compile_hyperband, compile_pbt,
    compile_fmin(asha=) and the host drivers raise unless the caller
    passes device="cpu"."""
    import numpy as np

    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.hyperband import (asha, compile_hyperband, compile_sha, hyperband,
                                              successive_halving)
    from hyperopt_tpu_torch.models.synthetic import (budgeted_quadratic_fn,
                                                     budgeted_quadratic_space,
                                                     mlp_tune_objective, mlp_tune_space)
    from hyperopt_tpu_torch.pbt import compile_pbt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    init = {"theta": np.zeros(4, np.float32)}
    bounds = {"lr": (1e-3, 1.0)}
    calls = [
        lambda: compile_sha(lambda s, h, k: (s, s["theta"]), init, bounds, 4),
        lambda: compile_hyperband(lambda s, h, k: (s, s["theta"]), lambda k, n: init, bounds, 1),
        lambda: compile_pbt(lambda s, h, k: (s, s["theta"]), init, bounds, 4),
        lambda: compile_fmin(mlp_tune_objective(n_epochs=1), mlp_tune_space(), 8, batch_size=4,
                             asha={"eta": 2}),
        lambda: successive_halving(budgeted_quadratic_fn, budgeted_quadratic_space(), 9),
        lambda: hyperband(budgeted_quadratic_fn, budgeted_quadratic_space(), 9),
        lambda: asha(budgeted_quadratic_fn, budgeted_quadratic_space(), 9, max_jobs=4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_fleet_router_and_fsck_in_a_fresh_process_load_no_jax(tmp_path):
    """(a'''') the fleet on the CPU -- three replicas, a kill and its
    failover, the pilot's scale-out, a TCP router in front of two replica
    fronts, the flight log replayed, fsck over the root -- and afterwards
    neither jax nor the JAX package is in sys.modules."""
    code = textwrap.dedent(f"""
        import sys, threading
        from hyperopt_tpu_torch.client import RemoteStudy
        from hyperopt_tpu_torch.distributed import fsck
        from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
        from hyperopt_tpu_torch.obs import FlightRecorder
        from hyperopt_tpu_torch.serve import (Fleet, FleetPilot, FleetRouter, PilotConfig,
                                              SuggestService)
        from hyperopt_tpu_torch.serve.fleet import fleet_salt
        from hyperopt_tpu_torch.serve.replay import ServiceTarget, load_workload, replay_workload
        from hyperopt_tpu_torch.serve.router import RouterServer, _Backend
        from hyperopt_tpu_torch.serve.service import serve_forever

        root, log = {str(tmp_path / "root")!r}, {str(tmp_path / "f.jsonl")!r}
        kw = dict(max_batch=4, n_startup_jobs=2, n_cand=8, device="cpu")
        fleet = Fleet(mixed_space(), root, n_replicas=3, recorder=FlightRecorder(path=log), **kw)
        router = FleetRouter(fleet)
        for i in range(4):
            router.create_study(f"s{{i}}", seed=i)
        for r in range(3):
            if r == 1:
                fleet.kill_replica(fleet.route("s0"))
            for n, (tid, vals) in router.ask_batch([f"s{{i}}" for i in range(4)]).items():
                router.tell(n, tid, mixed_space_fn(vals), vals=vals)
        pilot = FleetPilot(fleet, config=PilotConfig(max_replicas=3, queue_high=0, breach_ticks=1))
        assert pilot.tick().action == "scale_out"
        fleet.shutdown()
        target = ServiceTarget(SuggestService(mixed_space(), background=False, **kw))
        assert sum(map(len, replay_workload(load_workload(log), target).values())) == 12
        target.service.shutdown()
        assert fsck.main(["--serve", root]) == 0
        svcs = [SuggestService(mixed_space(), root=root + "2", owner=f"b{{i}}", **kw)
                for i in range(2)]
        fronts = [serve_forever(s, port=0) for s in svcs]
        for f in fronts:
            threading.Thread(target=f.serve_forever, daemon=True).start()
        rs = RouterServer([_Backend(f"b{{i}}", *f.server_address[:2])
                           for i, f in enumerate(fronts)],
                          salt=fleet_salt("tpe", mixed_space())).serve_forever(port=0)
        threading.Thread(target=rs.serve_forever, daemon=True).start()
        c = RemoteStudy(*rs.server_address[:2], "t", seed=1)
        tid, vals = c.ask(timeout=60)
        c.tell(tid, mixed_space_fn(vals), vals)
        c.close()
        for s in [rs] + fronts:
            s.shutdown()
            s.server_close()
        for s in svcs:
            s.shutdown()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hyperopt_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_cuda_means_no_silent_cpu_fleet(monkeypatch, tmp_path):
    """(c''') without CUDA, ``Fleet()`` raises unless the caller passes
    device="cpu", and builds no replica; ``router.main``, which serves
    nothing itself, answers a study whose backend is gone with a typed
    ``ReplicaDead`` and never builds a service of its own on the CPU."""
    import json
    import socket
    import threading

    from hyperopt_tpu_torch.serve import Fleet, router
    from hyperopt_tpu_torch.serve import service as service_mod
    from hyperopt_tpu_torch.serve.fleet import fleet_salt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Fleet(mixed_space(), str(tmp_path / "root"), n_replicas=2)
    assert not os.path.exists(str(tmp_path / "root")) or not os.listdir(str(tmp_path / "root"))

    def no_service(*args, **kw):
        raise AssertionError("the router built a service")

    monkeypatch.setattr(service_mod.SuggestService, "__init__", no_service)
    servers = []
    real = router.RouterServer.serve_forever

    def capture(self, *args, **kw):
        servers.append(real(self, *args, **kw))
        return servers[-1]

    monkeypatch.setattr(router.RouterServer, "serve_forever", capture)
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()  # nobody listens there
    done = []
    t = threading.Thread(target=lambda: done.append(router.main([
        "--salt", fleet_salt("tpe", mixed_space()), "--port", "0",
        "--probe-interval", "0", "--backend", f"r0=127.0.0.1:{dead_port}"])), daemon=True)
    t.start()
    for _ in range(500):
        if servers:
            break
        threading.Event().wait(0.01)
    host, port = servers[0].server_address[:2]
    with socket.create_connection((host, port), timeout=30) as sock:
        f = sock.makefile("rwb")
        f.write(b'{"op": "create_study", "name": "s", "seed": 1}\n')
        f.flush()
        reply = json.loads(f.readline())
        f.close()
    servers[0].shutdown()
    t.join(timeout=30)
    assert done == [0]
    assert not reply["ok"] and reply["error_type"] == "ReplicaDead", reply


def test_farming_in_a_fresh_process_loads_no_jax(tmp_path):
    """(a'''') the asynchronous backends on the CPU -- threads, filequeue
    with its worker, asha_queue, and the import-gated mongo and spark
    modules -- and afterwards neither jax nor the JAX package is loaded."""
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import hyperopt_tpu_torch as H
        from hyperopt_tpu_torch import distributed
        from hyperopt_tpu_torch.distributed import (
            asha_queue, filequeue, mongo, spark, threads, worker)
        from hyperopt_tpu_torch.models.synthetic import (
            budgeted_quadratic_fn, budgeted_quadratic_space, mixed_space, mixed_space_fn)
        t = distributed.ThreadTrials(parallelism=2)
        H.fmin(mixed_space_fn, mixed_space(), algo=H.tpe.suggest, max_evals=8, trials=t,
               rstate=np.random.default_rng(0), device="cpu", show_progressbar=False)
        assert len(t.trials) == 8
        ft = distributed.FileTrials({str(tmp_path / "q")!r}, reserve_timeout=None)
        domain = H.Domain(mixed_space_fn, mixed_space(), device="cpu")
        ft.insert_trial_docs(H.rand.suggest(ft.new_trial_ids(2), domain, ft, 0))
        import pickle
        ft.attachments["FMinIter_Domain"] = pickle.dumps(domain)
        while worker.run_one(ft.queue, "w"):
            pass
        assert ft.queue.counts()["done"] == 2
        for gated in (mongo.MongoTrials, spark.SparkTrials):
            try:
                gated()
            except (ImportError, TypeError):
                pass
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hyperopt_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_cuda_means_no_silent_cpu_farming(monkeypatch, tmp_path):
    """(c'''') without CUDA, ``ThreadTrials().fmin`` and
    ``asha_filequeue`` with ``device=None`` raise, evaluate nothing and
    publish no job."""
    from hyperopt_tpu_torch.distributed import FileJobQueue, ThreadTrials, asha_filequeue
    from hyperopt_tpu_torch.models.synthetic import budgeted_quadratic_fn, budgeted_quadratic_space

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    trials = ThreadTrials(parallelism=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trials.fmin(lambda cfg: ran.append(cfg) or 0.0, mixed_space(), max_evals=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H.fmin(mixed_space_fn, mixed_space(), max_evals=4, trials=ThreadTrials())
    assert len(trials.trials) == 0 and not ran
    dirpath = str(tmp_path / "q")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asha_filequeue(budgeted_quadratic_fn, budgeted_quadratic_space(), max_budget=9,
                       dirpath=dirpath, max_jobs=4)
    assert FileJobQueue(dirpath).counts() == {"new": 0, "running": 0, "done": 0}


def test_population_models_in_a_fresh_process_load_no_jax():
    """(a''''') the population models on the CPU -- a TinyLM PBT round and
    a ResNet population step -- and afterwards neither jax, flax, optax
    nor the JAX package is loaded."""
    code = textwrap.dedent("""
        import sys
        import torch
        from hyperopt_tpu_torch import random as R
        from hyperopt_tpu_torch.models import resnet, transformer
        from hyperopt_tpu_torch.pbt import compile_pbt

        lm = transformer.TinyLM(vocab=8, d_model=8, n_heads=2, n_layers=1, max_len=8)
        params = transformer.init_population(lm, 4, R.key(0), device="cpu")
        momentum = {k: torch.zeros_like(v) for k, v in params.items()}
        out = compile_pbt(transformer.make_pbt_train_fn(lm, 4, 8, 8), (params, momentum),
                          {"lr": (1e-3, 1.0), "wd": (1e-7, 1e-2)}, pop_size=4,
                          exploit_every=2, n_rounds=1, device="cpu")(seed=0)
        assert out["loss_history"].shape == (1, 4)
        net = resnet.ResNet(stage_sizes=(1, 1, 1), width=8)
        pop = resnet.init_population(net, 2, R.key(1), device="cpu")
        images, labels = resnet.synthetic_cifar_batch(R.key(2), 4, 8)
        step = resnet.make_population_train_step(net, device="cpu")
        _, _, losses = step(pop, {k: torch.zeros_like(v) for k, v in pop.items()},
                            torch.tensor([0.1, 0.01]), torch.tensor([1e-4, 1e-4]),
                            images, labels)
        assert torch.isfinite(losses).all()
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hyperopt_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_cuda_means_no_silent_cpu_population_models(monkeypatch):
    """(c''''') without CUDA, the TinyLM ``device_objective`` under
    ``compile_fmin``, its ``budget_objective`` and ``population_objective``,
    and ResNet's ``make_population_train_step``, ``init_population`` and
    ``population_objective`` with ``device=None`` raise rather than run on
    the CPU."""
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.models import resnet, transformer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = resnet.ResNet(stage_sizes=(1, 1, 1), width=8)
    calls = [
        lambda: compile_fmin(transformer.device_objective(), transformer.hpo_space(),
                             max_evals=8, batch_size=4),
        lambda: transformer.budget_objective(),
        lambda: transformer.population_objective(),
        lambda: transformer.make_population_train_step(transformer.TinyLM()),
        lambda: resnet.make_population_train_step(net),
        lambda: resnet.init_population(net, 2, R.key(0)),
        lambda: resnet.population_objective(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_sharded_suggest_in_a_fresh_process_loads_no_jax():
    """(a'''''') the rank-sharded suggest on the CPU -- one rank, a
    40-trial ``fmin`` past its 20 startup trials, and a two-rank virtual
    mesh -- and afterwards neither jax nor the JAX package is loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import hyperopt_tpu_torch as H
        from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
        from hyperopt_tpu_torch.parallel import sharded_suggest
        from hyperopt_tpu_torch.parallel.mesh import virtual_mesh
        t = H.Trials()
        H.fmin(mixed_space_fn, mixed_space(), algo=sharded_suggest, max_evals=40, trials=t,
               rstate=np.random.default_rng(0), device="cpu", show_progressbar=False)
        assert len(t.trials) == 40
        d = H.Domain(mixed_space_fn, mixed_space(), device="cpu")
        docs = sharded_suggest(t.new_trial_ids(2), d, t, seed=1, mesh=virtual_mesh(2))
        assert len(docs) == 2 and d._sharded_tpe_cache
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hyperopt_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_cuda_means_no_silent_cpu_sharded_suggest(monkeypatch):
    """(c'''''') without CUDA, ``fmin(algo=sharded_suggest)``, a direct
    ``sharded_suggest`` on a Domain with ``device=None`` and a
    ``dcn_check`` rank without ``--device`` raise rather than run on the
    CPU, and evaluate nothing."""
    from hyperopt_tpu_torch.parallel import dcn_check, sharded_suggest

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trials = H.Trials()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H.fmin(mixed_space_fn, mixed_space(), algo=sharded_suggest, max_evals=3, trials=trials)
    assert len(trials.trials) == 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sharded_suggest([0], H.Domain(mixed_space_fn, mixed_space()), trials, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dcn_check.main(["0", "2", "file:///nowhere"])
    assert not torch.distributed.is_initialized()


def test_sharded_service_and_schedules_in_a_fresh_process_load_no_jax():
    """(a''''''') a SuggestService on a two-shard study mesh, three rounds,
    and ``compile_pbt``/``compile_sha`` with ``shard_mode="shard_map"`` on
    a two-shard trial mesh, all on the CPU; afterwards neither jax nor
    the JAX package is loaded."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from hyperopt_tpu_torch.hyperband import compile_sha
        from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
        from hyperopt_tpu_torch.parallel.mesh import virtual_mesh
        from hyperopt_tpu_torch.pbt import compile_pbt
        from hyperopt_tpu_torch.serve import SuggestService
        svc = SuggestService(mixed_space(), max_batch=4, background=False, n_startup_jobs=2,
                             n_cand=16, mesh=virtual_mesh(2, "study"), device="cpu")
        hs = [svc.create_study(f"s{i}", seed=i) for i in range(4)]
        for _ in range(3):
            futs = [h.ask_async() for h in hs]
            svc.pump()
            for h, f in zip(hs, futs):
                tid, vals = f.result(timeout=60)
                h.tell(tid, mixed_space_fn(vals))
        assert svc.counters["mesh_shards"] == 2
        svc.shutdown()

        def train_fn(state, hypers, key):
            theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7)
            return {"theta": theta}, (theta - 0.7) ** 2

        init = {"theta": np.linspace(0.0, 5.0, 8, dtype=np.float32)}
        kw = dict(mesh=virtual_mesh(2, "trial"), shard_mode="shard_map", device="cpu")
        compile_pbt(train_fn, init, {"lr": (1e-3, 1.0)}, 8, n_rounds=2, **kw)(seed=0)
        compile_sha(train_fn, init, {"lr": (1e-3, 1.0)}, 8, steps_per_rung=1, **kw)(seed=0)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "hyperopt_tpu"))
        print("LOADED", bad)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_no_cuda_means_no_silent_cpu_sharded_service(monkeypatch):
    """(c''''''') without CUDA, a sharded SuggestService, the console
    script's ``--mesh-devices`` and the sharded schedules not asked for
    the CPU raise rather than run there."""
    from hyperopt_tpu_torch.hyperband import compile_sha
    from hyperopt_tpu_torch.parallel.mesh import virtual_mesh
    from hyperopt_tpu_torch.pbt import compile_pbt
    from hyperopt_tpu_torch.serve import SuggestService
    from hyperopt_tpu_torch.serve.service import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SuggestService(mixed_space(), background=False, mesh=virtual_mesh(2, "study"))
    with pytest.raises(SystemExit) as exc:
        main(["--space", "hyperopt_tpu_torch.models.synthetic:mixed_space",
              "--mesh-devices", "2"])
    assert exc.value.code == 2
    init = {"theta": torch.zeros(8)}
    kw = dict(mesh=virtual_mesh(2, "trial"), shard_mode="shard_map")
    for compile_fn in (compile_pbt, compile_sha):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            compile_fn(lambda s, h, k: (s, s["theta"]), init, {"lr": (1e-3, 1.0)}, 8, **kw)
