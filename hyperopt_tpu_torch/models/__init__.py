"""Benchmark spaces and model families of the PyTorch port.

``synthetic`` -- the spaces and objectives of the benchmarks and tests,
and the domain battery.  ``surrogate`` -- an HPOBench-style XGBoost
surrogate (8-dim mixed space, BASELINE.json config #3).  ``nasbench`` --
a NAS-Bench-201-style choice-heavy architecture search (config #5).
``resnet`` -- ResNet-20 with a vmapped population train step (BASELINE.json
config #4).  ``transformer`` -- a decoder-only LM on an in-context
next-token task, the same population-training shape.  The model families
load lazily: ``import hyperopt_tpu_torch.models`` builds no module.
"""

from . import synthetic

__all__ = ["synthetic"]


def __getattr__(name):
    if name in ("surrogate", "nasbench", "resnet", "transformer"):
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
