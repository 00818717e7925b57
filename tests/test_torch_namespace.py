"""The port's top-level namespace against the reference's.

Code written for ``hyperopt_tpu`` must find the same names on
``hyperopt_tpu_torch``: ``__all__`` equals the reference's less the
``*_jax`` modules (the port's ``tpe``, ``anneal``, ``atpe`` and ``rand``
are those algorithms) and the names still to be ported, listed here so
that each later slice shrinks the list.
"""

import os
import subprocess
import sys
import textwrap

import pytest

import hyperopt_tpu
import hyperopt_tpu_torch as H

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NAMES = {n for n in hyperopt_tpu.__all__ if n.endswith("_jax")}
NOT_YET_PORTED = set()
# lazy modules of the reference still to be ported: none is left
LAZY_NOT_YET_PORTED = set()
LAZY = ("device_loop", "hyperband", "pbt", "models", "distributed", "ops", "utils", "progress",
        "atpe", "vectorize", "pyll_utils", "criteria", "plotting", "graphviz", "mix",
        "tpe_host", "anneal_host", "atpe_host", "native", "parallel")


def test_all_equals_the_references_less_the_listed_names():
    want = set(hyperopt_tpu.__all__) - JAX_NAMES - NOT_YET_PORTED
    assert set(H.__all__) == want
    assert len(H.__all__) == len(set(H.__all__))
    assert JAX_NAMES == {"anneal_jax", "atpe_jax"}


@pytest.mark.parametrize("name", sorted(set(hyperopt_tpu.__all__) - JAX_NAMES - NOT_YET_PORTED))
def test_every_exported_name_resolves(name):
    obj = getattr(H, name)
    ref = getattr(hyperopt_tpu, name)
    if isinstance(ref, type):
        assert isinstance(obj, type) and obj.__name__ == ref.__name__
    elif isinstance(ref, (str, tuple, int)):
        assert obj == ref


def test_lazy_modules_resolve_and_unported_ones_do_not():
    for name in LAZY:
        assert getattr(H, name).__name__ == f"hyperopt_tpu_torch.{name}"
    assert H.models.transformer.__name__ == "hyperopt_tpu_torch.models.transformer"
    for name in NOT_YET_PORTED | LAZY_NOT_YET_PORTED:
        with pytest.raises(AttributeError):
            getattr(H, name)


def test_fmin_pass_expr_memo_ctrl_reaches_the_domain():
    from hyperopt_tpu_torch.models.synthetic import mixed_space

    @H.fmin_pass_expr_memo_ctrl
    def fn(expr, memo, ctrl):
        return 0.0

    assert H.Domain(fn, mixed_space(), device="cpu").pass_expr_memo_ctrl is True
    assert H.Domain(lambda cfg: 0.0, mixed_space(), device="cpu").pass_expr_memo_ctrl is False


def test_import_loads_no_lazy_module():
    """``import hyperopt_tpu_torch`` stays as cheap as before: the lazy
    modules load at first use only."""
    code = textwrap.dedent("""
        import sys
        import hyperopt_tpu_torch
        lazy = ("device_loop", "hyperband", "pbt", "models", "serve", "convert", "rand_host",
                "tpe_host", "anneal_host", "atpe_host", "native", "criteria", "plotting",
                "graphviz", "parallel")
        print("LOADED", sorted(m for m in lazy if f"hyperopt_tpu_torch.{m}" in sys.modules))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout
