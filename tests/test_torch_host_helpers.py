"""The port's small host modules against the reference's: ``criteria``
(on numpy arrays and on tensors), the ``vectorize``, ``base``,
``progress`` and ``utils`` helpers, ``graphviz`` and ``plotting``.

``criteria`` on numpy is the reference's code over scipy, so it is held
bitwise; on float64 tensors ``torch.special.erf`` stands in for scipy's
(the two differ by an ulp or so) and the results agree within
CRITERIA_RTOL, or CRITERIA_ATOL where EI's ``score * cdf + pdf``
cancels at negative scores and an ulp of ``erf`` is a larger share.
``graphviz`` names each node by its position in the graph's
depth-first order, never by object id, so its text is compared as it
is.  ``plotting`` draws under the Agg
backend and its line and scatter data are compared.
"""

import os

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import hyperopt_tpu as J  # noqa: E402
import hyperopt_tpu_torch as H  # noqa: E402
from hyperopt_tpu import base as jbase  # noqa: E402
from hyperopt_tpu import criteria as jc  # noqa: E402
from hyperopt_tpu import graphviz as jg  # noqa: E402
from hyperopt_tpu import plotting as jplot  # noqa: E402
from hyperopt_tpu import progress as jprogress  # noqa: E402
from hyperopt_tpu import rand as jrand  # noqa: E402
from hyperopt_tpu import utils as ju  # noqa: E402
from hyperopt_tpu import vectorize as jv  # noqa: E402
from hyperopt_tpu.models.synthetic import DOMAINS as J_DOMAINS  # noqa: E402
from hyperopt_tpu_torch import base as tbase  # noqa: E402
from hyperopt_tpu_torch import criteria as tc  # noqa: E402
from hyperopt_tpu_torch import graphviz as tg  # noqa: E402
from hyperopt_tpu_torch import plotting as tplot  # noqa: E402
from hyperopt_tpu_torch import progress as tprogress  # noqa: E402
from hyperopt_tpu_torch import rand_host as trand  # noqa: E402
from hyperopt_tpu_torch import utils as tu  # noqa: E402
from hyperopt_tpu_torch import vectorize as tv  # noqa: E402
from hyperopt_tpu_torch.models.synthetic import DOMAINS as T_DOMAINS  # noqa: E402

CRITERIA_RTOL, CRITERIA_ATOL = 1e-12, 1e-14
EQ = np.testing.assert_array_equal


def _gauss(seed=0, n=64):
    rng = np.random.default_rng(seed)
    # scores from deep in the tail (logEI's asymptotic branch) to far above
    return rng.normal(0.0, 3.0, n), rng.uniform(0.01, 4.0, n), 2.5


@pytest.mark.parametrize("fn", ["EI_gaussian", "logEI_gaussian", "UCB"])
def test_criteria_numpy_and_tensors(fn):
    mean, var, thresh = _gauss()
    if fn == "UCB":
        thresh = 1.3  # the z-score
    want = getattr(jc, fn)(mean, var, thresh)
    got = getattr(tc, fn)(mean, var, thresh)
    assert type(got) is type(want)
    EQ(got, want)
    on_tensors = getattr(tc, fn)(torch.from_numpy(mean), torch.from_numpy(var), thresh)
    assert torch.is_tensor(on_tensors) and on_tensors.dtype == torch.float64
    np.testing.assert_allclose(on_tensors.numpy(), want, rtol=CRITERIA_RTOL, atol=CRITERIA_ATOL)


def test_criteria_tail_and_empirical():
    mean, var = np.array([-40.0, -8.0, 0.0, 3.0]), np.array([1.0, 1.0, 2.0, 0.5])
    want = jc.logEI_gaussian(mean, var, 0.0)
    assert np.all(np.isfinite(want))
    got = tc.logEI_gaussian(torch.tensor(mean), torch.tensor(var), 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=CRITERIA_RTOL, atol=CRITERIA_ATOL)
    samples = np.random.default_rng(1).normal(size=100)
    assert tc.EI_empirical(samples, 0.2) == jc.EI_empirical(samples, 0.2)
    t = tc.EI_empirical(torch.from_numpy(samples), 0.2)
    assert torch.is_tensor(t)
    np.testing.assert_allclose(float(t), jc.EI_empirical(samples, 0.2), rtol=CRITERIA_RTOL,
                               atol=CRITERIA_ATOL)
    f32 = tc.EI_gaussian(torch.tensor([0.5], dtype=torch.float32), torch.tensor([2.0]), 0.1)
    assert f32.dtype == torch.float32
    assert tc.__all__ == jc.__all__


def _spaces():
    j, t = J_DOMAINS["many_dists"], T_DOMAINS["many_dists"]
    return j.make_space(), t.make_space()


def test_vectorize_helper_batches_and_sample_config():
    js, ts = _spaces()
    jh, th = jv.VectorizeHelper(js, s_new_ids="ids"), tv.VectorizeHelper(ts, s_new_ids="ids")
    assert th.s_new_ids == "ids" and th.labels == jh.labels
    with pytest.raises(RuntimeError):
        th.idxs_by_label()
    with pytest.raises(RuntimeError):
        th.vals_by_label()
    ids = list(range(10, 30))
    assert (jh.sample_batch(ids, np.random.default_rng(0))
            == th.sample_batch(ids, np.random.default_rng(0)))
    assert (th.idxs_by_label(), th.vals_by_label()) == (jh.idxs_by_label(), jh.vals_by_label())
    assert (jv.sample_config(js, np.random.default_rng(4))
            == tv.sample_config(ts, np.random.default_rng(4)))
    assert tv.__all__ == jv.__all__


def test_pretty_names_and_idxs_vals_to_dense():
    js, ts = _spaces()
    assert sorted(tv.pretty_names(ts).values()) == sorted(jv.pretty_names(js).values())
    assert (sorted(tv.pretty_names(ts, prefix="p").values())
            == sorted(jv.pretty_names(js, prefix="p").values()))
    th = tv.VectorizeHelper(ts)
    ids = list(range(12))
    idxs, vals = th.sample_batch(ids, np.random.default_rng(1))
    labels = th.labels
    for tids in (ids, ids[::2] + [99]):
        got = tv.idxs_vals_to_dense(tids, labels, idxs, vals, fill=-1.0)
        want = jv.idxs_vals_to_dense(tids, labels, idxs, vals, fill=-1.0)
        for g, w in zip(got, want):
            EQ(g, w)
    dense, active = tv.idxs_vals_to_dense(ids, labels, idxs, vals)
    assert tv.dense_to_idxs_vals(ids, labels, dense, active)[0] == idxs


def test_miscs_update_idxs_vals_round_trip():
    out = []
    for pkg, base, rand, domains in ((J, jbase, jrand, J_DOMAINS), (H, tbase, trand, T_DOMAINS)):
        kw = {} if pkg is J else {"device": "cpu"}
        dom = pkg.Domain(domains["many_dists"].fn, domains["many_dists"].make_space(), **kw)
        trials = pkg.Trials()
        docs = rand.suggest(list(range(8)), dom, trials, seed=2)
        miscs = [d["misc"] for d in docs]
        idxs, vals = base.miscs_to_idxs_vals(miscs)
        fresh = [{"tid": m["tid"], "idxs": {}, "vals": {}} for m in miscs]
        base.miscs_update_idxs_vals(fresh, idxs, vals)
        assert [(m["idxs"], m["vals"]) for m in fresh] == [(m["idxs"], m["vals"]) for m in miscs]
        mapped = [{"tid": 100 + m["tid"]} for m in miscs]
        base.miscs_update_idxs_vals(mapped, idxs, vals, idxs_map={t: 100 + t for t in range(8)})
        with pytest.raises(ValueError, match="not found"):
            base.miscs_update_idxs_vals(fresh[:3], idxs, vals)
        base.miscs_update_idxs_vals(fresh[:3], idxs, vals, assert_all_vals_used=False)
        out.append([fresh, mapped])
    assert out[0] == out[1]
    assert "miscs_update_idxs_vals" in tbase.__all__


def test_progress_default_callback():
    assert tprogress.default_callback is tprogress.tqdm_progress_callback
    assert tprogress.__all__ == jprogress.__all__


def test_utils_helpers(tmp_path):
    rng = np.random.default_rng(0)
    X, Y = rng.integers(0, 20, 50), rng.integers(0, 20, 10)
    EQ(tu.fast_isin(X, Y), ju.fast_isin(X, Y))
    EQ(tu.fast_isin(X, []), ju.fast_isin(X, []))
    docs = [{"_id": int(i), "version": int(v)}
            for i, v in zip(rng.integers(0, 6, 30), rng.integers(0, 4, 30))]
    docs.append({"_id": 9})
    EQ(tu.get_most_recent_inds(docs), ju.get_most_recent_inds(docs))
    for path in ("/a/b/c", "a/b/", "/", "rel", str(tmp_path / "x" / "y")):
        assert tu.path_split_all(path) == ju.path_split_all(path)
    (tmp_path / "exists").mkdir()
    for workdir in (str(tmp_path / "exists" / "missing" / "deeper"), str(tmp_path / "exists")):
        assert tu.get_closest_dir(workdir) == ju.get_closest_dir(workdir)
    with tu.temp_dir(suffix="_port") as d:
        assert os.path.isdir(d) and d.endswith("_port")
    assert os.path.isdir(d)  # kept, as the reference's
    os.rmdir(d)


@pytest.mark.parametrize("space", ["many_dists", "q1_choice", "mixed"])
def test_graphviz_text(space):
    if space == "mixed":
        from hyperopt_tpu.models.synthetic import mixed_space as jm
        from hyperopt_tpu_torch.models.synthetic import mixed_space as tm

        js, ts = jm(), tm()
    else:
        js, ts = J_DOMAINS[space].make_space(), T_DOMAINS[space].make_space()
    got = tg.dot_hyperparameters(ts)
    assert got == jg.dot_hyperparameters(js)
    assert got.startswith("digraph space {") and "fillcolor=lightblue" in got
    assert "shape=diamond" in got  # every space here has a choice: a switch


def _histories():
    """The same 30-trial history in each package, with one failed trial."""
    out = []
    for pkg, rand, domains in ((J, jrand, J_DOMAINS), (H, trand, T_DOMAINS)):
        kw = {} if pkg is J else {"device": "cpu"}
        d = domains["q1_choice"]
        calls = []

        def fn(cfg, d=d, calls=calls):
            calls.append(1)
            if len(calls) == 7:
                return {"status": "fail"}
            return d.fn(cfg)

        trials = pkg.Trials()
        pkg.fmin(fn, d.make_space(), algo=rand.suggest, max_evals=30, trials=trials,
                 rstate=np.random.default_rng(0), show_progressbar=False, **kw)
        out.append(trials)
    return out


def _figure_data(fig):
    data = []
    for ax in fig.axes:
        data.append((
            [ln.get_xydata().tolist() for ln in ax.get_lines()],
            [np.asarray(c.get_offsets()).tolist() for c in ax.collections],
            [(p.get_x(), p.get_height()) for p in ax.patches],
            ax.get_title(), ax.get_xlabel(), ax.get_ylabel(),
        ))
    return data


@pytest.mark.parametrize("plot", ["main_plot_history", "main_plot_histogram", "main_plot_vars"])
def test_plotting_data(plot):
    jtr, ttr = _histories()
    figs = []
    for mod, trials in ((jplot, jtr), (tplot, ttr)):
        plt.close("all")
        fig = getattr(mod, plot)(trials, do_show=False)
        figs.append(_figure_data(fig))
    plt.close("all")
    assert figs[0] == figs[1]
    assert figs[1] and (figs[1][0][0] or figs[1][0][1] or figs[1][0][2])


def test_plotting_without_data_warns():
    trials = H.Trials()
    assert tplot.main_plot_histogram(trials, do_show=False) is None
    assert tplot.main_plot_vars(trials, do_show=False) is None
    assert jg.__all__ == tg.__all__ and jplot.__all__ == tplot.__all__
