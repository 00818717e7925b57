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
FORBIDDEN = ("jax", "jaxlib", "hyperopt_tpu")


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
    """(b) no module of the port and nothing in chip_smoke.py imports jax
    or hyperopt_tpu (absolute imports; relative ones stay in the port)."""
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
