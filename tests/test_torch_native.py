"""The port's native host-math library (``hyperopt_tpu_torch.native``).

Its build lands in the package's ``_build/`` under a name keyed by the
source's digest; strict mode (``HYPEROPT_TPU_NATIVE=1``) raises on every
call after a failed build; its results agree with the port's numpy
oracle at the reference's own tolerances (``tests/test_native.py``:
1e-12 for the fit, 1e-9 for the log-density), and are bitwise the
reference's library on the same inputs (the same source built with the
same flags).
"""

import hashlib
import os

import numpy as np
import pytest

from hyperopt_tpu import native as j_native
from hyperopt_tpu_torch import native
from hyperopt_tpu_torch.tpe_host import (
    GMM1_lpdf,
    GMM1_lpdf_numpy,
    LGMM1_lpdf_numpy,
    adaptive_parzen_normal_numpy,
)

PKG = os.path.dirname(os.path.dirname(native.__file__))

# (low, high, q, logspace): the reference's cases
LPDF_CASES = [
    (None, None, None, False),
    (-2.0, 3.0, None, False),
    (0.0, 10.0, 1.0, False),
    (None, None, None, True),
    (-1.0, 1.0, None, True),
    (None, None, 0.5, True),
]


@pytest.fixture
def needs_native():
    """Skip where the library does not build here (no C++ toolchain);
    decided when the test runs, so every worker collects the same tests."""
    if not native.available():
        pytest.skip("no C++ toolchain / native build failed")


@pytest.fixture
def both_libraries(needs_native):
    if not j_native.available():
        pytest.skip("no C++ toolchain / the reference's native build failed")


@pytest.fixture
def fresh_state(monkeypatch, tmp_path):
    """The loader with nothing tried, building into a scratch copy of the
    build directory; the process's state is restored afterwards."""
    saved = dict(native._STATE)
    native._STATE.update(lib=None, tried=False, strict_error=None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    yield tmp_path / "_build"
    native._STATE.clear()
    native._STATE.update(saved)


@pytest.mark.usefixtures("needs_native")
def test_build_lands_in_build_dir_under_the_source_digest():
    path = native.lib_path()
    assert os.path.dirname(path) == os.path.join(PKG, "_build")
    with open(os.path.join(os.path.dirname(native.__file__), "tpe_math.cpp"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    assert os.path.basename(path).endswith(f"_{digest}.so")
    assert os.path.exists(path)
    assert not any(n.endswith(".so") for n in os.listdir(os.path.dirname(native.__file__)))


def test_a_changed_source_gets_another_library(monkeypatch, tmp_path):
    src = tmp_path / "tpe_math.cpp"
    with open(native._SRC) as f:
        src.write_text(f.read())
    monkeypatch.setattr(native, "_SRC", str(src))
    before = native.lib_path()
    src.write_text(src.read_text() + "\n// edited\n")
    assert native.lib_path() != before


def test_strict_mode_raises_on_every_call(monkeypatch, fresh_state):
    """A broken compiler under HYPEROPT_TPU_NATIVE=1 fails every caller,
    not only the first; switching strict mode off restores the numpy
    fallback."""
    monkeypatch.setenv("HYPEROPT_TPU_NATIVE", "1")
    monkeypatch.setattr(native, "_CXX", os.path.join(str(fresh_state), "no-such-g++"))
    with pytest.raises(FileNotFoundError):
        native._load()
    for call in (native._load, native.available,
                 lambda: native.gmm_lpdf([0.0], [1.0], [0.0], [1.0]),
                 lambda: native.adaptive_parzen([0.5], 1.0, 0.0, 1.0, 25)):
        with pytest.raises(RuntimeError, match="HYPEROPT_TPU_NATIVE=1"):
            call()
    assert not os.path.exists(fresh_state) or not os.listdir(fresh_state)
    monkeypatch.setenv("HYPEROPT_TPU_NATIVE", "0")
    assert native._load() is None
    assert native.available() is False


def test_auto_mode_falls_back_and_zero_opts_out(monkeypatch, fresh_state):
    monkeypatch.setenv("HYPEROPT_TPU_NATIVE", "auto")
    monkeypatch.setattr(native, "_CXX", os.path.join(str(fresh_state), "no-such-g++"))
    assert native.available() is False
    assert native.gmm_lpdf([0.0], [1.0], [0.0], [1.0]) is None
    native._STATE.update(lib=None, tried=False, strict_error=None)
    monkeypatch.setenv("HYPEROPT_TPU_NATIVE", "0")
    monkeypatch.setattr(native, "build", lambda force=False: pytest.fail("built under =0"))
    assert native.available() is False


@pytest.mark.usefixtures("needs_native")
@pytest.mark.parametrize("n_obs", [0, 1, 2, 7, 40])
def test_adaptive_parzen_against_numpy(n_obs):
    obs = np.random.default_rng(n_obs).normal(0.5, 2.0, n_obs)
    want = adaptive_parzen_normal_numpy(obs, 1.0, 0.0, 5.0, 25)
    got = native.adaptive_parzen(obs, 1.0, 0.0, 5.0, 25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


@pytest.mark.usefixtures("needs_native")
def test_adaptive_parzen_no_forgetting_against_numpy():
    obs = np.random.default_rng(9).normal(0, 1, 30)
    want = adaptive_parzen_normal_numpy(obs, 0.5, 1.0, 3.0, 0)
    got = native.adaptive_parzen(obs, 0.5, 1.0, 3.0, 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)


def _lpdf_inputs(low, high, q, logspace, seed=0, K=9, S=40):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, K)
    w = w / w.sum()
    mu = rng.normal(0.5, 1.5, K)
    sigma = rng.uniform(0.2, 2.0, K)
    if logspace:
        x = rng.uniform(0.05, 6.0, S)
        if q:
            x = np.maximum(np.round(x / q) * q, 0.0)
    else:
        x = rng.uniform(-3.0, 8.0, S)
        if q:
            x = np.clip(np.round(x / q) * q, low, high)
    return x, w, mu, sigma


@pytest.mark.usefixtures("needs_native")
@pytest.mark.parametrize("low,high,q,logspace", LPDF_CASES)
def test_gmm_lpdf_against_numpy(low, high, q, logspace):
    x, w, mu, sigma = _lpdf_inputs(low, high, q, logspace)
    oracle = LGMM1_lpdf_numpy if logspace else GMM1_lpdf_numpy
    want = oracle(x, w, mu, sigma, low=low, high=high, q=q)
    got = native.gmm_lpdf(x, w, mu, sigma, low=low, high=high, q=q, logspace=logspace)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.usefixtures("needs_native")
def test_public_lpdf_dispatches_to_the_library():
    x = np.random.default_rng(3).normal(0, 2, 16)
    w, mu, sigma = np.array([0.3, 0.7]), np.array([-1.0, 2.0]), np.array([0.5, 1.5])
    np.testing.assert_allclose(GMM1_lpdf(x, w, mu, sigma, low=-4.0, high=4.0),
                               GMM1_lpdf_numpy(x, w, mu, sigma, low=-4.0, high=4.0), rtol=1e-9)
    np.testing.assert_array_equal(GMM1_lpdf(x, w, mu, sigma, low=-4.0, high=4.0),
                                  native.gmm_lpdf(x, w, mu, sigma, low=-4.0, high=4.0))


@pytest.mark.usefixtures("both_libraries")
@pytest.mark.parametrize("case", range(len(LPDF_CASES) + 3))
def test_bitwise_the_references_library(case):
    """The same inputs through both packages' libraries."""
    if case < len(LPDF_CASES):
        low, high, q, logspace = LPDF_CASES[case]
        args = _lpdf_inputs(low, high, q, logspace, seed=case, K=33, S=200)
        kw = dict(low=low, high=high, q=q, logspace=logspace)
        np.testing.assert_array_equal(native.gmm_lpdf(*args, **kw), j_native.gmm_lpdf(*args, **kw))
    else:
        n = (0, 5, 300)[case - len(LPDF_CASES)]
        obs = np.random.default_rng(case).normal(0.5, 2.0, n)
        for g, w in zip(native.adaptive_parzen(obs, 1.0, 0.0, 5.0, 25),
                        j_native.adaptive_parzen(obs, 1.0, 0.0, 5.0, 25)):
            np.testing.assert_array_equal(g, w)
