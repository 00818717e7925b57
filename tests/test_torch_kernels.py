"""The port's TPE math (hyperopt_tpu_torch.ops.kernels) against the
reference's (hyperopt_tpu.ops.kernels), function by function, on
randomized masked buffers made from numpy seeds.

Masks, indices, sort orders and categorical picks must be exactly equal.
Floats are compared at stated tolerances: FIT_RTOL (1e-5) for sums whose
order differs between XLA's reductions and PyTorch's, and SPECIAL_RTOL
(2e-5) where ``exp``/``log``/``ndtr``/``ndtri`` -- whose last bits differ
between the two libraries -- feed further arithmetic (XLA also contracts
multiply-adds into FMAs, PyTorch rounds each op).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperopt_tpu.ops import kernels as JK
from hyperopt_tpu_torch import convert
from hyperopt_tpu_torch.ops import kernels as TK

FIT_RTOL = 1e-5
SPECIAL_RTOL = 2e-5


def T(a):
    return torch.from_numpy(np.array(a))


def jvmap(fn, **kw):
    """The reference function vmapped and jitted, as the reference runs it
    (eager op-by-op dispatch would dominate the test's time)."""
    return jax.jit(jax.vmap(fn, **kw))


def N(a):
    return a.numpy() if torch.is_tensor(a) else np.asarray(a)


def masked_rows(seed, rows=5, n=64, tie_levels=None):
    """obs [rows, n] (optionally rounded to few levels, to force ties)
    and a random mask with one empty and one full row."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(0.5, 2.0, (rows, n)).astype(np.float32)
    if tie_levels:
        obs = np.round(obs * tie_levels) / tie_levels
    mask = rng.random((rows, n)) < rng.uniform(0.1, 0.9, (rows, 1))
    mask[0] = False
    mask[-1] = True
    return obs.astype(np.float32), mask


def assert_merged_close(want, got, w, mu, sig, width):
    """compact_gmm outputs within their conditioning.

    A merged group's moments are differences of prefix cumsums, whose
    rounding (XLA's scan associates differently from PyTorch's) scales
    with the running total at the group's end, not with the group: a
    group's weight carries ``eps * total``, its mu ``eps * (sum |w mu| +
    |mu_g| total) / w_g`` and its variance ``eps * (sum w (mu^2 + s^2) +
    mu_g^2 total) / w_g``.  The bound below is 16x that, per group, from
    float64 prefix sums of the inputs (a singleton group passes through
    untouched and gets the same, loose, bound)."""
    eps = float(np.finfo(np.float32).eps)
    w64, mu64, s64 = (np.asarray(a, np.float64) for a in (w, mu, sig))
    k = w64.shape[-1]
    n_live = np.sum(w64 > 0, axis=-1, keepdims=True)
    g = np.arange(width + 1)
    bounds = np.clip((g * np.maximum(n_live, width) + width - 1) // width, 0, k)
    zero = np.zeros(w64.shape[:-1] + (1,))

    def prefix(x):
        return np.concatenate([zero, np.cumsum(x, axis=-1)], axis=-1)

    p0, p1, p2 = prefix(w64), prefix(np.abs(w64 * mu64)), prefix(w64 * (mu64**2 + s64**2))
    hi, lo = bounds[..., 1:], bounds[..., :-1]
    tot0 = np.take_along_axis(p0, hi, -1)
    w_g = np.maximum(tot0 - np.take_along_axis(p0, lo, -1), 1e-30)
    mu_g = (np.take_along_axis(prefix(w64 * mu64), hi, -1)
            - np.take_along_axis(prefix(w64 * mu64), lo, -1)) / w_g
    tol_w = 16 * eps * tot0
    tol_mu = 16 * eps * (np.take_along_axis(p1, hi, -1) + np.abs(mu_g) * tot0) / w_g
    tol_var = 16 * eps * (np.take_along_axis(p2, hi, -1) + mu_g**2 * tot0) / w_g
    (ww, wm, ws), (gw, gm, gs) = ((N(a) for a in t) for t in (want, got))
    assert np.all(np.abs(gw - ww) <= tol_w + 1e-6 * np.abs(ww))
    assert np.all(np.abs(gm - wm) <= tol_mu + 1e-6 * np.abs(wm))
    var_w, var_g = ws.astype(np.float64) ** 2, gs.astype(np.float64) ** 2
    assert np.all(np.abs(var_g - var_w) <= tol_var + 1e-6 * var_w)


@pytest.mark.parametrize("lf", [3.0, 25.0])
def test_forgetting_weights(lf):
    _, mask = masked_rows(0)
    want = jvmap(lambda m: JK.forgetting_weights(m, lf))(jnp.asarray(mask))
    np.testing.assert_allclose(N(TK.forgetting_weights(T(mask), lf)), want, rtol=FIT_RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_below_above_masks_exact(seed):
    rng = np.random.default_rng(seed)
    losses = np.round(rng.normal(0, 1, 200), 1).astype(np.float32)  # many ties
    losses[rng.random(200) < 0.05] = np.inf
    losses[rng.random(200) < 0.05] = np.nan
    valid = rng.random(200) < 0.8
    jb, ja, jn = JK.split_below_above(jnp.asarray(losses), jnp.asarray(valid), 0.25, 25.0)
    tb, ta, tn = TK.split_below_above(T(losses), T(valid), 0.25, 25.0)
    assert np.array_equal(N(jb), N(tb)) and np.array_equal(N(ja), N(ta))
    assert float(jn) == float(tn)


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_below_order_exact(seed):
    obs, mask = masked_rows(seed, n=128)
    jo, jm = jvmap(lambda o, m: JK.compact_below(o, m, 16))(
        jnp.asarray(obs), jnp.asarray(mask))
    to, tm = TK.compact_below(T(obs), T(mask), 16)
    assert np.array_equal(N(jm), N(tm))
    assert np.array_equal(N(jo), N(to))  # gathered by identical indices


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_parzen_fit(seed):
    obs, mask = masked_rows(seed, tie_levels=2)  # ties, and mus equal to the prior
    rows = obs.shape[0]
    pm = np.full(rows, 0.5, np.float32)
    ps = np.linspace(2.0, 8.0, rows).astype(np.float32)
    pw = np.ones(rows, np.float32)
    lf = np.full(rows, 25.0, np.float32)
    want = jvmap(JK.parzen_fit)(*(jnp.asarray(a) for a in (obs, mask, pm, ps, pw, lf)))
    got = TK.parzen_fit(*(T(a) for a in (obs, mask, pm, ps, pw, lf)))
    w, mu, sig = (N(a) for a in want)
    tw, tmu, tsig = (N(a) for a in got)
    assert np.array_equal(mu, tmu)  # the same floats in the same (stable) order
    assert np.array_equal(sig, tsig)  # gaps and clips of equal floats
    assert np.array_equal(w > 0, tw > 0)
    np.testing.assert_allclose(tw, w, rtol=FIT_RTOL, atol=1e-7)


@pytest.mark.parametrize("n_live", [5, 40, 64])
def test_compact_gmm(n_live):
    """Identity while the live count fits the width; moment-matched
    groups past it."""
    rng = np.random.default_rng(n_live)
    k, width = 65, 16
    w = np.zeros((3, k), np.float32)
    w[:, :n_live] = rng.uniform(0.1, 1.0, (3, n_live))
    w /= w.sum(-1, keepdims=True)
    mu = np.sort(rng.normal(0, 3, (3, k)), axis=-1).astype(np.float32)
    mu[:, n_live:] = 0.0
    sig = rng.uniform(0.2, 2.0, (3, k)).astype(np.float32)
    sig[:, n_live:] = 1.0
    want = jvmap(lambda *a: JK.compact_gmm(*a, width))(
        jnp.asarray(w), jnp.asarray(mu), jnp.asarray(sig))
    got = TK.compact_gmm(T(w), T(mu), T(sig), width)
    assert_merged_close(want, got, w, mu, sig, width)
    if n_live <= width:
        assert np.array_equal(N(got[1]), N(want[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_categorical_fit(seed):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 5, (4, 64)).astype(np.float32)
    mask = rng.random((4, 64)) < 0.6
    prior = np.zeros((4, 6), np.float32)
    prior[:, :5] = 0.2
    prior[1, 3:] = 0.0
    prior[1, :3] = 1 / 3
    pw = np.ones(4, np.float32)
    lf = np.full(4, 25.0, np.float32)
    want = jvmap(JK.categorical_fit)(*(jnp.asarray(a) for a in (obs, mask, prior, pw, lf)))
    got = TK.categorical_fit(*(T(a) for a in (obs, mask, prior, pw, lf)))
    np.testing.assert_allclose(N(got), N(want), rtol=FIT_RTOL)


def _dims():
    """Per-dim constants: bounded, log-space, quantized and unbounded."""
    low = np.array([-5.0, -5.0, 0.0, -np.inf], np.float32)
    high = np.array([5.0, 2.0, 20.0, np.inf], np.float32)
    logspace = np.array([False, True, False, False])
    q = np.array([0.0, 0.0, 1.0, 0.0], np.float32)
    return low, high, logspace, q


def _mixture(seed, k=9, dead=2):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.1, 1.0, (4, k)).astype(np.float32)
    w[:, k - dead:] = 0.0  # zero-weight padding, as parzen_fit leaves it
    w /= w.sum(-1, keepdims=True)
    mu = rng.normal(0.5, 2.0, (4, k)).astype(np.float32)
    sig = rng.uniform(0.3, 3.0, (4, k)).astype(np.float32)
    return w, mu, sig


def _pre_pair(seed):
    low, high, _, _ = _dims()
    w, mu, sig = _mixture(seed)
    jpre = jvmap(JK.gmm_precompute)(*(jnp.asarray(a) for a in (w, mu, sig, low, high)))
    tpre = TK.gmm_precompute(*(T(a) for a in (w, mu, sig, low, high)))
    return jpre, tpre


def test_quantize_nat():
    low, high, logspace, q = _dims()
    rng = np.random.default_rng(0)
    nat = rng.uniform(-6, 25, (4, 50)).astype(np.float32)
    q = np.array([0.5, 0.1, 1.0, 0.0], np.float32)
    args = (nat, q[:, None], low[:, None], high[:, None], logspace[:, None])
    want = JK.quantize_nat(*(jnp.asarray(a) for a in args))
    got = TK.quantize_nat(*(T(a) for a in args))
    np.testing.assert_allclose(N(got), N(want), rtol=SPECIAL_RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_gmm_precompute(seed):
    jpre, tpre = _pre_pair(seed)
    assert set(jpre) == set(tpre)
    for k in jpre:
        a, b = N(jpre[k]), N(tpre[k])
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), k
        np.testing.assert_allclose(b, a, rtol=SPECIAL_RTOL, atol=1e-6, err_msg=k)


def test_inverse_cdf_onehot_exact():
    rng = np.random.default_rng(0)
    u = rng.random((4, 100)).astype(np.float32)
    cdf = np.cumsum(rng.uniform(0, 1, (4, 7)), axis=-1).astype(np.float32)
    cdf[:, -2:] = cdf[:, -3:-2]  # zero-width padded intervals
    want = jvmap(JK._inverse_cdf_onehot)(jnp.asarray(u), jnp.asarray(cdf))
    got = TK._inverse_cdf_onehot(T(u), T(cdf))
    assert np.array_equal(N(want), N(got))
    assert np.all(N(got).sum(-1) == 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_trunc_gmm_sample_pre(seed):
    low, high, logspace, q = _dims()
    jpre, tpre = _pre_pair(seed)
    keys = jax.random.split(jax.random.key(seed), 4)
    want = jvmap(lambda *a: JK.trunc_gmm_sample_pre(*a, 128))(
        keys, jpre, jnp.asarray(low), jnp.asarray(high), jnp.asarray(logspace),
        jnp.asarray(q))
    got = TK.trunc_gmm_sample_pre(
        convert.key_from_numpy(jax.random.key_data(keys), device="cpu"), tpre,
        T(low), T(high), T(logspace), T(q), 128)
    np.testing.assert_allclose(N(got), N(want), rtol=SPECIAL_RTOL, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_gmm_logpdf_pre(seed):
    """Both scorers on in-bounds candidates.  (A bin mass below FLT_MIN
    is where the two differ: XLA flushes the subnormal to zero and
    scores -inf, PyTorch keeps it and scores the documented log(1e-38)
    floor; in-bounds candidates never get there, the prior component
    alone gives every bin a normal-range mass.)"""
    low, high, logspace, q = _dims()
    jpre, tpre = _pre_pair(seed)
    rng = np.random.default_rng(seed)
    # candidates inside each dim's bounds, as the sampler draws them
    lo = np.where(logspace, np.exp(low), low).clip(-8.0, None)
    hi = np.where(logspace, np.exp(high), high).clip(None, 8.0)
    x = rng.uniform(lo[:, None], hi[:, None], (4, 128)).astype(np.float32)
    x[2] = np.round(x[2])
    q = np.array([0.5, 0.1, 1.0, 0.5], np.float32)
    wc = jvmap(JK.gmm_logpdf_cont_pre)(jnp.asarray(x), jpre, jnp.asarray(logspace))
    gc = TK.gmm_logpdf_cont_pre(T(x), tpre, T(logspace))
    np.testing.assert_allclose(N(gc), N(wc), rtol=SPECIAL_RTOL, atol=1e-5)
    wq = jvmap(JK.gmm_logpdf_quant_pre)(
        jnp.asarray(x), jpre, *(jnp.asarray(a) for a in (low, high, logspace, q)))
    gq = TK.gmm_logpdf_quant_pre(T(x), tpre, *(T(a) for a in (low, high, logspace, q)))
    # a bin mass is the difference of two ndtr values one bin apart: their
    # last-bit differences (~6e-8 near 0.5) reach the log divided by the
    # mass, so narrow bins need an absolute 2e-3 (measured max 6.3e-4)
    np.testing.assert_allclose(N(gq), N(wq), rtol=SPECIAL_RTOL, atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ei_sweep_cat_exact(seed):
    """Dirichlet posteriors (no exact llr ties): picks equal exactly."""
    rng = np.random.default_rng(seed)
    pb = rng.dirichlet(np.ones(6), 5).astype(np.float32)
    pa = rng.dirichlet(np.ones(6), 5).astype(np.float32)
    pb[2, 4:] = 0.0  # a dim with fewer options
    pb[2] /= pb[2].sum()
    keys = jax.random.split(jax.random.key(seed), 8 * 5).reshape(8, 5)
    jv, js = jax.jit(JK.ei_sweep_cat, static_argnums=3)(keys, jnp.asarray(pb), jnp.asarray(pa), 24)
    tv, ts = TK.ei_sweep_cat(
        convert.key_from_numpy(jax.random.key_data(keys), device="cpu"),
        T(pb), T(pa), 24)
    assert np.array_equal(N(jv), N(tv))
    np.testing.assert_allclose(N(ts), N(js), rtol=SPECIAL_RTOL)


@pytest.mark.parametrize("n_obs,above_cap", [(200, 512), (600, 512), (200, 64)])
def test_fit_all_dims(n_obs, above_cap):
    """All fits of the 20-dim mixed space from one history; (600, 512)
    and (200, 64) take the above model through compact_gmm."""
    from hyperopt_tpu.models.synthetic import mixed_space
    from hyperopt_tpu.ops.compile import compile_space

    ps = compile_space(mixed_space())
    rng = np.random.default_rng(n_obs)
    cap = 1024 if n_obs > 512 else 256
    values, active = (np.asarray(a) for a in ps.sample_prior(jax.random.key(0), cap))
    losses = rng.normal(0, 1, cap).astype(np.float32)
    valid = np.arange(cap) < n_obs
    ref_fit = jax.jit(lambda *h: JK.fit_all_dims(
        ps._consts, *h, 0.25, 25.0, 1.0, above_cap=above_cap))
    want = ref_fit(*(jnp.asarray(a) for a in (values, active, losses, valid)))
    got = TK.fit_all_dims(
        convert.space_consts_from_numpy(ps, device="cpu"),
        *convert.history_from_numpy(values, active, losses, valid, device="cpu"),
        0.25, 25.0, 1.0, above_cap=above_cap)
    wb, mb, sb, wa, ma, sa = (N(a) for a in want["cont"])
    twb, tmb, tsb, twa, tma, tsa = (N(a) for a in got["cont"])
    assert twa.shape == wa.shape and twb.shape == wb.shape
    np.testing.assert_allclose(tmb, mb, rtol=FIT_RTOL)  # log dims: log's last bit
    np.testing.assert_allclose(tsb, sb, rtol=FIT_RTOL)
    np.testing.assert_allclose(twb, wb, rtol=FIT_RTOL, atol=1e-7)
    if wa.shape[1] == cap + 1:  # not compacted
        for a, b in ((wa, twa), (ma, tma), (sa, tsa)):
            np.testing.assert_allclose(b, a, rtol=FIT_RTOL, atol=1e-7)
    else:  # merged from the full-width fit (see assert_merged_close)
        full = TK.fit_all_dims(
            convert.space_consts_from_numpy(ps, device="cpu"),
            *convert.history_from_numpy(values, active, losses, valid, device="cpu"),
            0.25, 25.0, 1.0)["cont"][3:]
        assert_merged_close((wa, ma, sa), (twa, tma, tsa), *(N(a) for a in full),
                            wa.shape[1])
    for a, b in zip(want["cat"], got["cat"]):
        np.testing.assert_allclose(N(b), N(a), rtol=FIT_RTOL)
