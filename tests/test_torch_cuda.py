"""Tests of the port that need the card (marker ``cuda``).

They skip, inside the test, where ``torch.cuda.is_available()`` is false.
Every ``fmin`` passes ``show_progressbar=False``: the card's machine may
lack ``tqdm``.  They import no JAX, so the machine with the card runs
them with::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as H
from hyperopt_tpu_torch import tpe
from hyperopt_tpu_torch.models.synthetic import mixed_space, mixed_space_fn
from hyperopt_tpu_torch.ops import gmm_scores as G
from hyperopt_tpu_torch.ops import kernels as TK


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def subnormal_band_case(k=512, device="cpu"):
    """Every term of the above mixture lies below 2**-126 (t about
    -88.5) while their sum, some ``k * 3.7e-39``, is far above 1e-38: a
    flushed exp would take the fallback where the plain version takes
    the log of the sum, log(k) apart."""
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    rng = np.random.default_rng(5)
    mu = rng.uniform(-0.01, 0.01, (1, k))
    inf = np.full(1, np.inf)
    pre_a = TK.gmm_precompute(f(np.full((1, k), 1.0 / k)), f(mu), f(np.ones((1, k))),
                              f(-inf), f(inf))
    pre_b = TK.gmm_precompute(f([[1.0]]), f([[13.0]]), f([[1.0]]), f(-inf), f(inf))
    x = f(np.linspace(13.29, 13.32, 8))[None, None]
    return (x, torch.zeros(1, dtype=torch.bool, device=device),
            {k_: pre_b[k_].contiguous() for k_ in G._PRE_KEYS},
            {k_: pre_a[k_].contiguous() for k_ in G._PRE_KEYS})


def _inputs(device, B=64, Dg=12, S=128, Kb=9, Ka=512, seed=3):
    """One unquantized group at the main path's shapes for a 500-obs
    history of the 20-dim mixed space: 8 uniform and 4 log-space dims."""
    rng = np.random.default_rng(seed)
    logspace = np.arange(Dg) % 3 == 1
    low = np.full(Dg, -5.0, np.float32)
    high = np.where(logspace, 2.0, 5.0).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
    pres = []
    for k in (Kb, Ka):
        w = rng.uniform(0.05, 1.0, (Dg, k))
        w[:, k - 2:] = 0.0  # zero-weight padding
        w /= w.sum(-1, keepdims=True)
        mu = rng.uniform(low[:, None], high[:, None], (Dg, k))
        sig = rng.uniform(0.05, 3.0, (Dg, k))
        pre = TK.gmm_precompute(t(w), t(mu), t(sig), t(low), t(high))
        pres.append({k_: pre[k_].contiguous() for k_ in G._PRE_KEYS})
    lo = np.where(logspace, np.exp(low), low)[None, :, None]
    hi = np.where(logspace, np.exp(high), high)[None, :, None]
    x = t(rng.uniform(lo, hi, (B, Dg, S)))
    return x, torch.from_numpy(logspace).to(device), pres[0], pres[1]


def _assert_close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=G.KERNEL_RTOL, atol=G.KERNEL_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Dg,S,Kb,Ka", [
    (64, 12, 128, 9, 512),   # suggest_batch at B=64
    (3, 12, 100, 9, 1300),   # a ragged edge, both mixtures past one staging
    (1, 12, 7, 9, 1),        # a one-component mixture
    (1, 12, 128, 17, 512),   # the sequential ask
    (2, 3, 64, 9, 5000),     # the above mixture staged in three chunks
    (5, 1, 37, 9, 40),       # one dim, a ragged S
])
def test_cuda_kernel_matches_plain(cuda, B, Dg, S, Kb, Ka):
    """The hand-written kernel against the plain version on the card at
    the kernel's stated tolerance (``G.KERNEL_ATOL``: the exp is
    ``ex2.approx`` of a float32 ``t * log2(e)``; derivation in
    ops/gmm_scores.py)."""
    x, ls, pb, pa = _inputs(cuda, B=B, Dg=Dg, S=S, Kb=Kb, Ka=Ka)
    before = G.KERNEL.launches
    got = G.gmm_llr(x, ls, pb, pa)
    torch.cuda.synchronize()
    assert G.KERNEL.launches == before + 1
    _assert_close(got, G.gmm_llr_plain(x, ls, pb, pa))


@pytest.mark.cuda
@pytest.mark.parametrize("config", G.CONFIGS, ids=lambda c: f"k_lanes{c[0]}-rows{c[1]}")
def test_cuda_every_config_matches_plain(cuda, config):
    """Each split the kernel is compiled for, whichever the wrapper would
    pick, on a ragged shape with a chunked above mixture."""
    x, ls, pb, pa = _inputs(cuda, B=3, Dg=4, S=90, Kb=17, Ka=2100)
    out = torch.empty_like(x)
    assert G.launch(x, ls, pb, pa, out, config) == 0
    torch.cuda.synchronize()
    _assert_close(out, G.gmm_llr_plain(x, ls, pb, pa))


@pytest.mark.cuda
def test_cuda_subnormal_band(cuda):
    """Terms each below 2**-126 whose sum is far above 1e-38: the kernel
    takes the log of the sum, as the plain version does, not the
    fallback that a flushed exp would reach (about log(512) away)."""
    x, ls, pb, pa = subnormal_band_case(device=cuda)
    want = G.gmm_llr_plain(x, ls, pb, pa)
    _assert_close(G.gmm_llr(x, ls, pb, pa), want)
    for config in G.CONFIGS:
        out = torch.empty_like(x)
        assert G.launch(x, ls, pb, pa, out, config) == 0
        _assert_close(out, want)


@pytest.mark.cuda
def test_cuda_two_launches_are_bitwise_equal(cuda):
    """No atomics and a fixed combine order: the same inputs give the
    same bits on every launch."""
    for shape in (dict(B=1, Kb=17), dict(B=64), dict(B=3, S=100, Ka=2100)):
        x, ls, pb, pa = _inputs(cuda, **shape)
        first = G.gmm_llr(x, ls, pb, pa)
        second = G.gmm_llr(x, ls, pb, pa)
        assert torch.equal(first, second), shape


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, ls, pb, pa = _inputs(cuda, B=2, S=16)
    with pytest.raises(ValueError):
        G.gmm_llr(x.transpose(0, 2).contiguous().transpose(0, 2), ls, pb, pa)  # strided
    with pytest.raises(ValueError):
        G.gmm_llr(x.double(), ls, pb, pa)
    with pytest.raises(ValueError):
        G.gmm_llr(x, ls, pb, {**pa, "c1max": pa["c1max"].cpu()})


@pytest.mark.cuda
def test_cuda_fmin_runs_through_the_kernel(cuda):
    """A short fmin on the card: one kernel launch per TPE ask."""
    G.KERNEL.launches = 0
    trials = H.Trials()
    H.fmin(mixed_space_fn, mixed_space(), algo=tpe.suggest, max_evals=30,
           trials=trials, rstate=np.random.default_rng(0), show_progressbar=False)
    assert len(trials.trials) == 30
    assert G.KERNEL.launches == 10


@pytest.mark.cuda
def test_cuda_fused_stream_equals_plain(cuda):
    """100 trials on the card: the fused ask-ahead driver over a resident
    TorchTrials gives the plain driver's loss stream bit for bit, with
    one more launch (the pre-dispatch after the last result)."""
    runs = {}
    for name, algo, trials in (("plain", tpe.suggest, H.Trials()),
                               ("fused", H.partial(tpe.suggest, fused=True),
                                H.TorchTrials(resident=True))):
        G.KERNEL.launches = 0
        H.fmin(mixed_space_fn, mixed_space(), algo=algo, max_evals=100, trials=trials,
               rstate=np.random.default_rng(0), show_progressbar=False)
        runs[name] = (trials.losses(), G.KERNEL.launches)
    assert runs["fused"][0] == runs["plain"][0]
    assert (runs["plain"][1], runs["fused"][1]) == (80, 81)


@pytest.mark.cuda
def test_cuda_atpe_device_fn_matches_cpu(cuda):
    """``build_atpe_device_fn`` at B=64 on a 500-obs history: the same
    settings on the card and on the CPU, equal active masks, and every
    differing pick a near-tie of the CPU's own sweep (chip_smoke.py's
    rule, phase 6e)."""
    import importlib.util
    import os

    from hyperopt_tpu_torch import atpe, random as R
    from hyperopt_tpu_torch.torch_trials import obs_buffer_for, packed_space_for

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = {}
    gpu = H.Domain(mixed_space_fn, mixed_space(), device="cuda")
    trials = smoke.history_trials(gpu, 500, seed=11)
    for name, d in (("cuda", gpu), ("cpu", H.Domain(mixed_space_fn, mixed_space(), device="cpu"))):
        ps = packed_space_for(d)
        state = obs_buffer_for(d, trials).device_arrays(pow2_cap=TK.DEFAULT_ABOVE_CAP)
        fn = atpe.build_atpe_device_fn(ps, 25.0)
        v, a = fn(R.key(9, device=ps.device), *state, 64)
        g, pw, *_ = fn.settings(state.losses, state.valid)
        out[name] = (v.cpu().numpy(), a.cpu().numpy(), float(g), float(pw), ps, state)
    (gv, ga, gg, gpw, _, _), (cv, ca, cg, cpw, ps, state) = out["cuda"], out["cpu"]
    assert (gg, gpw) == (cg, cpw) and np.array_equal(ga, ca)
    margins = smoke.sweep_margins(ps, state, R.split(R.key(9), 3)[0], torch.tensor(cg),
                                  torch.tensor(cpw), 256, 24, 64)
    cat = np.zeros(ps.n_dims, bool)
    cat[ps.cat_idx] = True
    same = np.where(cat[:, None], gv == cv, np.isclose(gv, cv, rtol=1e-4, atol=1e-5))
    assert np.all(same | (margins < smoke.NEAR_TIE))


@pytest.mark.cuda
@pytest.mark.parametrize("n_studies,B", [(64, 1), (5, 3)])
def test_cuda_stacked_launch_is_bitwise_per_study_launches(cuda, n_studies, B):
    """gmm_llr_stacked folds N studies into one launch at the split of
    one study's shape: each study's scores are bitwise its own gmm_llr
    launch, and within the kernel's tolerance of the plain version."""
    per = [_inputs(cuda, B=B, seed=100 + i) for i in range(n_studies)]
    x = torch.stack([p[0] for p in per])
    stack = lambda j: {k: torch.stack([p[j][k] for p in per]) for k in G._PRE_KEYS}  # noqa: E731
    G.KERNEL.launches = 0
    got = G.gmm_llr_stacked(x, per[0][1], stack(2), stack(3))
    assert G.KERNEL.launches == 1
    for i, p in enumerate(per):
        one = G.gmm_llr(*p)
        assert torch.equal(got[i], one), i
        _assert_close(got[i], G.gmm_llr_plain(*p))


@pytest.mark.cuda
def test_cuda_service_serves_four_studies_through_one_launch_per_round(cuda):
    """A 4-study SuggestService on the card (device=None): one gmm_llr
    launch per round from the first (every slot runs the TPE body), the
    state on the card, finite suggestions inside the space."""
    from hyperopt_tpu_torch.serve import SuggestService

    svc = SuggestService(mixed_space(), max_batch=4, background=False, n_startup_jobs=3,
                         n_cand=128)
    assert svc.device.type == "cuda"
    handles = [svc.create_study(f"c{i}", seed=i) for i in range(4)]
    G.KERNEL.launches = 0
    for r in range(6):
        futs = [h.ask_async() for h in handles]
        assert svc.pump() == 4
        assert G.KERNEL.launches == r + 1
        for h, f in zip(handles, futs):
            tid, vals = f.result(timeout=60)
            assert len(vals) == 20 and all(np.isfinite(v) for v in vals.values())
            assert all(-5 <= vals[f"u{j}"] <= 5 for j in range(8))
            h.tell(tid, mixed_space_fn(vals))
    assert svc.scheduler._state.values.device.type == "cuda"
    assert svc.counters["dispatch_count"] == 6 and svc.counters["quarantine_count"] == 0
    svc.shutdown()


@pytest.mark.cuda
def test_cuda_background_service_runs_rounds_on_its_device(cuda):
    """The background loop's thread drives CUDA rounds on the service's
    device."""
    from hyperopt_tpu_torch.serve import SuggestService

    svc = SuggestService(mixed_space(), max_batch=4, n_startup_jobs=3, device="cuda:0")
    h = svc.create_study("bg", seed=1)
    for _ in range(5):
        tid, vals = h.ask(timeout=60)
        h.tell(tid, mixed_space_fn(vals))
    assert h.n_tells == 5 and svc.counters["dispatch_count"] == 5
    svc.shutdown()


def _stacked_histories(ps, n_studies, n_obs, cap, seed):
    """``n_studies`` histories of ``n_obs`` prior draws each, stacked to
    ``[N, D, cap]``, scored by ``mixed_space_fn``."""
    from hyperopt_tpu_torch import random as R

    vs, acts, ls = [], [], []
    for i in range(n_studies):
        v, a = ps.sample_prior(R.key(seed + i, device=ps.device), cap)
        vs.append(v)
        acts.append(a)
        ls.append(torch.rand(cap, generator=torch.Generator().manual_seed(seed + i)).to(ps.device))
    valid = (torch.arange(cap, device=ps.device) < n_obs).expand(n_studies, cap).contiguous()
    return torch.stack(vs), torch.stack(acts), torch.stack(ls), valid


@pytest.mark.cuda
def test_cuda_stacked_tpe_step_is_bitwise_per_study(cuda):
    """The repair of the per-study bits: at 64 studies of 500 observations,
    every fit tensor, every candidate and llr, and every suggestion of a
    study's slice of the stacked TPE step is bitwise the same study
    computed alone (the fits' sums and scans add in a fixed order)."""
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.ops.compile import compile_space

    ps = compile_space(mixed_space(), device=cuda)
    n = 64
    state = _stacked_histories(ps, n, 500, 512, seed=40)
    keys = torch.stack([R.key(7 + i, device=cuda) for i in range(n)])
    fit = lambda st: TK.fit_all_dims(ps.consts, *st, 0.25, 25.0, 1.0,  # noqa: E731
                                     above_cap=TK.DEFAULT_ABOVE_CAP)
    stacked = fit(state)
    dc = len(ps.cont_idx)
    cont_keys = R.split(keys, dc + len(ps.cat_idx))[:, :dc].reshape(n, 1, dc, 2)
    cand = TK.ei_sweep_cont_candidates(ps.q, ps.consts, cont_keys, stacked["cont"], 128)
    step = tpe.build_suggest_fn(ps, 128, 0.25, 25.0, 1.0, n_cand_cat=24)
    new_v, _ = step(keys, *state, 1)
    for i in range(n):
        one = tuple(t[i] for t in state)
        solo = fit(one)
        for a, b in zip(stacked["cont"] + stacked["cat"], solo["cont"] + solo["cat"]):
            assert torch.equal(a[i], b), i
        c = TK.ei_sweep_cont_candidates(ps.q, ps.consts, cont_keys[i], solo["cont"], 128)
        assert torch.equal(cand[0][i], c[0]) and torch.equal(cand[1][i], c[1]), i
        assert torch.equal(new_v[i], step(keys[i], *one, 1)[0]), i


@pytest.mark.cuda
def test_cuda_steps_copy_nothing_from_the_host(cuda):
    """The eager TPE (factorized and joint), anneal, ATPE and prior steps,
    once warm, run under ``set_sync_debug_mode("error")``: no blocking
    host-to-device copy is left in a step that a graph captures."""
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.anneal import build_anneal_fn
    from hyperopt_tpu_torch.atpe import build_atpe_device_fn
    from hyperopt_tpu_torch.ops.compile import compile_space

    ps = compile_space(mixed_space(), device=cuda)
    state = tuple(t[0] for t in _stacked_histories(ps, 1, 200, 256, seed=3))
    key = R.key(5, device=cuda)
    steps = [tpe.build_suggest_fn(ps, 128, 0.25, 25.0, 1.0, n_cand_cat=24),
             tpe.build_suggest_fn(ps, 32, 0.25, 25.0, 1.0, joint_ei=True),
             build_anneal_fn(ps, 2.0, 0.1), build_atpe_device_fn(ps, 25.0)]
    for fn in steps:
        fn(key, *state, 2)
    ps.sample_prior(key, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in steps:
            fn(key, *state, 2)
        ps.sample_prior(key, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_cuda_compiled_loop_replays_its_eager_step(cuda):
    """compile_fmin on the card: each step one graph replay holding one
    gmm_llr launch in the model regime; the replayed stream is bitwise
    the same steps run eagerly; a seed sweep is bitwise each solo run."""
    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.models.synthetic import mixed_space_fn_torch

    runner = compile_fmin(mixed_space_fn_torch, mixed_space(), max_evals=60,
                          n_startup_jobs=20, n_EI_candidates=128, n_EI_candidates_cat=24)
    out = runner(seed=3)
    prog = runner._program()
    assert set(prog.graphs) == {"prior", "model"}
    assert prog.launches_per_replay == {"prior": 0, "model": 1}
    assert prog.replays == {"prior": 20, "model": 40}
    prog.reset(3, None, 0, float("inf"))
    for j in range(60):
        prog.step(runner._program().loop.regime(j, 0))
    values, active, losses, _ = prog.host_state()
    assert np.array_equal(values[:, :60], out["values"])
    assert np.array_equal(losses[:60], out["losses"])
    swept = runner(seed=[3, 4])
    assert np.array_equal(swept[0]["values"], out["values"])
    assert np.array_equal(swept[1]["losses"], runner(seed=4)["losses"])


@pytest.mark.cuda
def test_cuda_gmm_llr_launch_is_recorded_in_a_capture(cuda):
    """The ctypes launch of the kernel lands in a CUDA graph: a replay on
    new inputs (written into the captured tensors) gives the eager
    launch's bits on them."""
    x, ls, pb, pa = _inputs(cuda, B=1, Kb=17)
    G.gmm_llr(x, ls, pb, pa)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = G.gmm_llr(x, ls, pb, pa)
    x2, _, pb2, pa2 = _inputs(cuda, B=1, Kb=17, seed=11)
    x.copy_(x2)
    for pre, new in ((pb, pb2), (pa, pa2)):
        for k in G._PRE_KEYS:
            pre[k].copy_(new[k])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, G.gmm_llr(x2, ls, pb2, pa2))


def _sync_checked(run):
    """``run()`` under ``set_sync_debug_mode("error")``: a host read or a
    blocking copy inside it raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return run()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_cuda_asha_bracket_replays_its_eager_bracket(cuda):
    """compile_fmin(asha=) on the card: one graph per regime, each bracket
    one replay holding one gmm_llr launch in the model regime; the
    replayed stream (history, rung record, artifact rows) is bitwise the
    same brackets run eagerly, and an eager bracket copies nothing from
    the host."""
    from hyperopt_tpu_torch.device_loop import compile_fmin
    from hyperopt_tpu_torch.models.synthetic import mlp_tune_objective, mlp_tune_space

    rows = []
    runner = compile_fmin(mlp_tune_objective(n_epochs=1, n_train=32, in_dim=4, hidden=8),
                          mlp_tune_space(), max_evals=48, batch_size=8, n_startup_jobs=8,
                          n_EI_candidates=16, asha={"eta": 2, "rung_epochs": 1, "n_rungs": 3},
                          chunk_size=16, artifact_callback=rows.append)
    out = runner(seed=3)
    prog = runner._program()
    assert set(prog.graphs) == {"prior", "model"}
    assert prog.launches_per_replay == {"prior": 0, "model": 1}
    assert prog.replays == {"prior": 1, "model": 5}
    assert len(rows) == 6 and [r["bracket"] for r in rows] == list(range(6))
    prog.reset(3, None, 0, float("inf"))
    prog.step("prior")
    _sync_checked(lambda: [prog.step("model") for _ in range(5)])
    values, active, losses, valid, rung_of = prog.host_state()
    assert np.array_equal(values[:, :48], out["values"])
    assert np.array_equal(losses[:48], out["losses"])
    assert np.array_equal(rung_of[:48], out["rung_of"])
    # the last chunk's winner rows: the eager brackets wrote the same bits
    for j, row in enumerate(rows[4:]):
        assert int(prog.win["slot"][j]) == row["slot"]
        assert float(prog.win["loss"][j]) == row["loss"]
        assert np.array_equal(prog.win["params"][0]["w1"][j].cpu().numpy(),
                              row["params"][0]["w1"])


def _quad_train_fn(state, hypers, key):
    theta = state["theta"] - hypers["lr"] * 2.0 * (state["theta"] - 0.7)
    return {"theta": theta}, (theta - 0.7) ** 2


@pytest.mark.cuda
def test_cuda_sha_rungs_replay_their_eager_rungs(cuda, tmp_path):
    """compile_sha on the card (replicas=2): one captured graph per rung;
    the replayed chain is bitwise the eager rungs, a warm rung copies
    nothing from the host, and a finished snapshot resumes bitwise."""
    from hyperopt_tpu_torch.hyperband import compile_sha

    init = {"theta": torch.linspace(-2.0, 3.0, 16, device=cuda)}
    runner = compile_sha(_quad_train_fn, init, {"lr": (1e-3, 1.2)}, n_configs=8, eta=2,
                         steps_per_rung=2, replicas=2)
    out = runner(seed=4)
    assert len(runner._graphs) == 4
    eager = runner._run(4, None, eager=True)
    assert eager["rungs"] == out["rungs"] and eager["best_index"] == out["best_index"]
    _sync_checked(lambda: [runner._rung_step(r) for r in range(len(runner._ladder))])
    assert torch.equal(eager["state"]["theta"], out["state"]["theta"])
    path = str(tmp_path / "sha.npz")
    durable = runner(seed=4, checkpoint=path)  # one host read per rung
    assert durable["rungs"] == out["rungs"]
    resumed = runner(seed=4, checkpoint=path)  # a finished snapshot: no device work
    assert resumed["rungs"] == out["rungs"]
    assert torch.equal(resumed["state"]["theta"], out["state"]["theta"])


@pytest.mark.cuda
def test_cuda_pbt_round_replays_its_eager_round(cuda):
    """compile_pbt on the card: one round captured, replayed n_rounds
    times, bitwise the eager rounds; a warm round copies nothing from the
    host; a resume replays as its eager run."""
    from hyperopt_tpu_torch.pbt import compile_pbt

    init = {"theta": torch.full((8,), 5.0, device=cuda)}
    runner = compile_pbt(_quad_train_fn, init, {"lr": (1e-4, 1.5)}, pop_size=8,
                         exploit_every=4, n_rounds=6)
    out = runner(seed=0)
    assert len(runner._graph) == 1
    eager = runner._run(0, None, eager=True)
    runner._round_index.zero_()
    _sync_checked(runner._round)
    assert np.array_equal(eager["loss_history"], out["loss_history"])
    assert np.array_equal(eager["log_hypers"], out["log_hypers"])
    resumed = runner(seed=0, init=out)
    assert np.array_equal(resumed["loss_history"],
                          runner._run(0, out, eager=True)["loss_history"])


def _engine_stream(trials):
    return [(t["misc"]["vals"], t["result"]) for t in trials.trials]


@pytest.mark.cuda
def test_cuda_engine_fmin_is_the_solo_fused_stream(cuda):
    """``fmin(engine=True)`` on the card at ask_ahead 1 and 3: bitwise the
    solo fused driver's stream from the same rstate, one ``gmm_llr``
    launch per ask (the stacked step runs the TPE body every round)."""
    n = 60
    ref = H.TorchTrials(resident=True)
    H.fmin(mixed_space_fn, mixed_space(), algo=H.partial(tpe.suggest, fused=True), max_evals=n,
           trials=ref, rstate=np.random.default_rng(0), show_progressbar=False)
    for k in (1, 3):
        trials = H.Trials()
        G.KERNEL.launches = 0
        H.fmin(mixed_space_fn, mixed_space(), algo=tpe.suggest, max_evals=n, trials=trials,
               rstate=np.random.default_rng(0), show_progressbar=False, engine=True,
               ask_ahead=k)
        assert _engine_stream(trials) == _engine_stream(ref), k
        assert G.KERNEL.launches == n, (k, G.KERNEL.launches)


@pytest.mark.cuda
def test_cuda_engine_kill_and_resume_is_bitwise(cuda, tmp_path):
    """An engine-routed fmin on a study root, killed at a serve crash
    point past startup and resumed: bitwise the uninterrupted stream,
    every tell logged once, and the resumed asks launch the kernel."""
    from hyperopt_tpu_torch.client import resolve_engine_algo
    from hyperopt_tpu_torch.distributed.faults import FaultPlan, SimulatedCrash
    from hyperopt_tpu_torch.serve import SuggestService
    from hyperopt_tpu_torch.utils.wal import TellWAL

    n, root = 40, str(tmp_path / "root")

    def service(fs):
        return SuggestService(mixed_space(), root=root, fs=fs, background=False, max_batch=1,
                              n_startup_jobs=20, snapshot_cadence=8, finite_check=False,
                              **resolve_engine_algo(tpe.suggest).algo_kw)

    def run(svc):
        trials = H.Trials()
        H.fmin(mixed_space_fn, mixed_space(), algo=tpe.suggest, max_evals=n, trials=trials,
               rstate=np.random.default_rng(1), show_progressbar=False, engine=svc)
        return trials

    ref = H.Trials()
    H.fmin(mixed_space_fn, mixed_space(), algo=H.partial(tpe.suggest, fused=True), max_evals=n,
           trials=ref, rstate=np.random.default_rng(1), show_progressbar=False)
    plan = FaultPlan(seed=0).arm("serve_mid_batch", at=30)
    with pytest.raises(SimulatedCrash):
        run(service(plan.fs()))
    svc = service(FaultPlan(seed=1).fs())
    G.KERNEL.launches = 0
    trials = run(svc)
    assert _engine_stream(trials) == _engine_stream(ref)
    assert [t["tid"] for t in trials.trials] == list(range(n))
    assert TellWAL(f"{root}/fmin.wal").total_tells == n
    assert G.KERNEL.launches == svc.counters["dispatch_count"] == n - 29


@pytest.mark.cuda
def test_cuda_persisted_round_reads_no_device_state(cuda, tmp_path):
    """A persisted study on the card: the submit (its WAL ask record),
    the tell (WAL record, host apply, snapshot cadence), the gated pump
    (the fresh_window gate and the group-commit barrier) run under
    ``set_sync_debug_mode("error")``; only the dispatch reads the card."""
    from hyperopt_tpu_torch.serve import SuggestService

    svc = SuggestService(mixed_space(), root=str(tmp_path / "root"), background=False,
                         max_batch=2, n_startup_jobs=3, snapshot_cadence=4)
    h = svc.create_study("s", seed=1)
    h._study.fresh_window = 1
    for r in range(8):
        fut = _sync_checked(h.ask_async)
        assert svc.pump() == 1
        tid, vals = fut.result(timeout=60)
        gated = _sync_checked(h.ask_async)  # one suggestion owes its tell
        assert _sync_checked(svc.pump) == 0 and not gated.done()
        _sync_checked(lambda: h.tell(tid, mixed_space_fn(vals)))
        assert svc.pump() == 1
        tid, vals = gated.result(timeout=60)
        _sync_checked(lambda: h.tell(tid, mixed_space_fn(vals)))
    c = svc.counters
    assert c["wal_tells"] == 16 and c["group_commit_barriers"] == 15  # none after the last tell
    svc.shutdown()


@pytest.mark.cuda
def test_cuda_atpe_hook_launches_from_the_serve_thread(cuda):
    """ATPE through a background service's host_algo hook: bitwise the
    solo ATPE stream, each warm ask's sweep launched from the scheduler's
    loop thread."""
    import threading

    from hyperopt_tpu_torch.serve import SuggestService

    n = 40
    ref = H.Trials()
    H.fmin(mixed_space_fn, mixed_space(), algo=H.atpe.suggest, max_evals=n, trials=ref,
           rstate=np.random.default_rng(2), show_progressbar=False)
    threads, real = [], G._launch_checked

    def recording(*args):
        threads.append(threading.current_thread().name)
        return real(*args)

    svc = SuggestService(mixed_space(), algo="atpe", max_batch=1, n_startup_jobs=20,
                         finite_check=False)
    trials = H.Trials()
    G._launch_checked = recording
    try:
        H.fmin(mixed_space_fn, mixed_space(), algo=H.atpe.suggest, max_evals=n, trials=trials,
               rstate=np.random.default_rng(2), show_progressbar=False, engine=svc)
    finally:
        G._launch_checked = real
    svc.shutdown()
    assert _engine_stream(trials) == _engine_stream(ref)
    assert threads and set(threads) == {"serve-batcher"} and len(threads) == n - 20


def _socket_rounds(svc, names, rounds, loss):
    """``rounds`` rounds over the service's TCP front: one ``ask_batch``
    frame for every study, then one pipelined tell each; returns each
    study's stream."""
    import threading

    from hyperopt_tpu_torch.serve.frames import FrameConn, dial
    from hyperopt_tpu_torch.serve.service import serve_forever

    srv = serve_forever(svc, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    sock, f = dial(*srv.server_address[:2], read_timeout=120)
    conn = FrameConn(f)
    streams = {n: [] for n in names}
    try:
        for n in names:
            assert conn.call({"op": "create_study", "name": n, "seed": int(n[1:])})["ok"]
        for _ in range(rounds):
            reply = conn.call({"op": "ask_batch", "names": names, "timeout": 120})
            assert reply["ok"], reply
            tells = []
            for n in names:
                r = reply["results"][n]
                assert r["ok"], (n, r)
                streams[n].append(r["vals"])
                tells.append(conn.submit({"op": "tell", "study": n, "tid": r["tid"],
                                          "loss": loss(r["vals"]), "vals": r["vals"]}))
            assert all(conn.drain(t)["ok"] for t in tells)
    finally:
        conn.close()
        sock.close()
        srv.shutdown()
        srv.server_close()
    return streams


def _inprocess_rounds(svc, names, rounds, loss):
    handles = [svc.create_study(n, seed=int(n[1:])) for n in names]
    streams = {n: [] for n in names}
    for _ in range(rounds):
        futs = [h.ask_async() for h in handles]
        assert svc.pump() == len(handles)
        for h, fut in zip(handles, futs):
            tid, vals = fut.result(timeout=120)
            streams[h.name].append(vals)
            h.tell(tid, loss(vals))
    return streams


@pytest.mark.cuda
def test_cuda_socket_round_is_bitwise_the_in_process_round(cuda):
    """Four studies over the TCP front on binary frames (the handler's
    thread pumps each ``ask_batch`` round): every study's stream is
    bitwise the in-process service's, one ``gmm_llr`` launch per round."""
    from hyperopt_tpu_torch.serve import SuggestService

    names, rounds = [f"s{i}" for i in range(4)], 6
    kw = dict(max_batch=4, background=False, n_startup_jobs=3, n_cand=128)
    ref = SuggestService(mixed_space(), **kw)
    want = _inprocess_rounds(ref, names, rounds, mixed_space_fn)
    ref.shutdown()
    svc = SuggestService(mixed_space(), **kw)
    G.KERNEL.launches = 0
    got = _socket_rounds(svc, names, rounds, mixed_space_fn)
    assert got == want
    assert G.KERNEL.launches == svc.counters["dispatch_count"] == rounds
    svc.shutdown()


@pytest.mark.cuda
def test_cuda_ask_batch_pumped_from_a_handler_thread_is_sync_free(cuda):
    """With no background loop, ``ask_batch`` pumps rounds from the socket
    handler's thread.  Under ``set_sync_debug_mode("error")`` everything
    that thread does outside the round's dispatch (the submits, the
    pick, the group-commit barrier, the tells, and at cadence 0 nothing
    after the acks) runs without reading the card; a sync would fail the
    reply."""
    import functools

    from hyperopt_tpu_torch.serve import SuggestService

    svc = SuggestService(mixed_space(), max_batch=4, background=False, n_startup_jobs=3,
                         n_cand=128, device_metrics_every=0)
    sched = svc.scheduler
    real = sched._dispatch_round

    @functools.wraps(real)
    def dispatch_may_sync(picked):
        torch.cuda.set_sync_debug_mode("default")
        try:
            return real(picked)
        finally:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")

    sched._dispatch_round = dispatch_may_sync
    names = [f"s{i}" for i in range(4)]
    for n in names:  # the socket's create_study then re-attaches
        svc.create_study(n, seed=int(n[1:]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        streams = _socket_rounds(svc, names, 5, mixed_space_fn)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(len(s) == 5 for s in streams.values())
    assert sched.device_metric_dispatches == 0 and sched._device_metrics_fn is None
    svc.shutdown()


@pytest.mark.cuda
def test_cuda_twin_at_cadence_2_leaves_the_streams_bitwise(cuda):
    """The device-metrics twin every 2 rounds on the card: the streams are
    bitwise those at cadence 0, the launches one per round either way,
    and the twin ran every second round."""
    from hyperopt_tpu_torch.serve import SuggestService

    names, rounds, out = [f"s{i}" for i in range(4)], 6, {}
    for every in (0, 2):
        svc = SuggestService(mixed_space(), max_batch=4, background=False, n_startup_jobs=3,
                             n_cand=128, device_metrics_every=every)
        G.KERNEL.launches = 0
        out[every] = _inprocess_rounds(svc, names, rounds, mixed_space_fn)
        assert G.KERNEL.launches == rounds
        assert svc.scheduler.device_metric_dispatches == rounds // 2 * (every > 0)
        if every:
            rows = {r["name"]: r.get("value") for r in svc.metrics_rows()}
            assert rows["serve_device_trials_done"] == 4 * (rounds - 1)
            assert rows["serve_device_active_slots"] == 4
        svc.shutdown()
    assert out[2] == out[0]


def _farm_stream(trials):
    return [(t["tid"], t["misc"]["vals"], t["result"]) for t in trials.trials]


def _farm_twin(n, seed):
    twin = H.Trials()
    G.KERNEL.launches = 0
    H.fmin(mixed_space_fn, mixed_space(), algo=tpe.suggest, max_evals=n, trials=twin,
           max_queue_len=4, rstate=np.random.default_rng(seed), show_progressbar=False)
    return _farm_stream(twin), G.KERNEL.launches


@pytest.mark.cuda
def test_cuda_thread_trials_are_the_sequential_twin(cuda):
    """``ThreadTrials(parallelism=4)`` with TPE on the card, each objective
    thread running card work of its own: bitwise the sequential
    ``max_queue_len=4`` stream, one launch per post-startup ask."""
    from hyperopt_tpu_torch.distributed import ThreadTrials

    def objective(cfg):
        a = torch.ones(512, 512, device="cuda")
        (a @ a).sum().item()
        return mixed_space_fn(cfg)

    want, twin_launches = _farm_twin(40, 6)
    trials = ThreadTrials(parallelism=4)
    G.KERNEL.launches = 0
    H.fmin(objective, mixed_space(), algo=tpe.suggest, max_evals=40, trials=trials,
           rstate=np.random.default_rng(6), show_progressbar=False)
    assert _farm_stream(trials) == want
    assert G.KERNEL.launches == twin_launches == 5  # 5 TPE asks of 4 after 20 startup


@pytest.mark.cuda
def test_cuda_mongo_trials_are_the_sequential_twin(cuda, monkeypatch):
    """``MongoTrials`` over the in-memory doubles with an in-process
    ``MongoWorker``, TPE on the card: bitwise the sequential stream."""
    import threading
    import time

    from fake_backends import install_fake_mongo

    install_fake_mongo(monkeypatch)
    from hyperopt_tpu_torch.distributed.mongo import MongoJobs, MongoTrials, MongoWorker

    conn = "localhost:27017/db_cuda"
    trials = MongoTrials(f"mongo://{conn}/jobs")
    worker = MongoWorker(MongoJobs.new_from_connection_str(conn))
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            if not worker.run_one("host:1"):
                time.sleep(0.005)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    want, twin_launches = _farm_twin(32, 7)
    G.KERNEL.launches = 0
    try:
        H.fmin(mixed_space_fn, mixed_space(), algo=tpe.suggest, max_evals=32, trials=trials,
               max_queue_len=4, rstate=np.random.default_rng(7), show_progressbar=False)
    finally:
        stop.set()
        th.join(timeout=30)
    assert _farm_stream(trials) == want
    assert G.KERNEL.launches == twin_launches == 3


def _population_case(model_mod, model, device, pop=4):
    """A tiny population of ``model`` made on the CPU and copied to
    ``device``, with distinct lr/wd and the step's data."""
    from hyperopt_tpu_torch import random as R

    params = model_mod.init_population(model, pop, R.key(0), device="cpu")
    lr = torch.tensor([0.3, 0.1, 0.03, 0.01][:pop])
    wd = torch.tensor([1e-5, 1e-4, 1e-3, 1e-2][:pop])
    if model_mod.__name__.endswith("transformer"):
        data = (model_mod.synthetic_token_batch(R.key(1), 16, 16, 16),)
    else:
        data = model_mod.synthetic_cifar_batch(R.key(1), 8, 8)
    move = lambda t: t.to(device)  # noqa: E731
    return ({k: move(v) for k, v in params.items()},
            {k: torch.zeros_like(move(v)) for k, v in params.items()},
            move(lr), move(wd), *(move(d) for d in data))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["transformer", "resnet"])
def test_cuda_population_step_matches_the_cpu(cuda, family):
    """Three population steps of the tiny TinyLM (vocab 16, d 16, one
    layer) and ResNet (1-1-1, width 8, 8x8 images) on the card against
    the same steps on the CPU: losses within 1e-4 relative, parameters
    within 1e-5 (two float32 implementations of the same layers; TF32 is
    off)."""
    import importlib

    mod = importlib.import_module(f"hyperopt_tpu_torch.models.{family}")
    model = (mod.TinyLM(vocab=16, d_model=16, n_heads=2, n_layers=1, max_len=16)
             if family == "transformer" else mod.ResNet(stage_sizes=(1, 1, 1), width=8))
    outs = {}
    for dev in ("cpu", cuda):
        step = mod.make_population_train_step(model, device=dev)
        p, m, lr, wd, *data = _population_case(mod, model, dev)
        for _ in range(3):
            p, m, loss = step(p, m, lr, wd, *data)
        outs[str(dev)] = ({k: v.cpu() for k, v in p.items()}, loss.cpu())
    (pc, lc), (pg, lg) = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=0)
    for k in pc:
        torch.testing.assert_close(pg[k], pc[k], rtol=0, atol=1e-5, msg=k)
    assert len(set(lg.tolist())) > 1


@pytest.mark.cuda
def test_cuda_tinylm_pbt_round_replays_its_eager_round(cuda):
    """compile_pbt on a tiny TinyLM population on the card: the captured
    round (tokens drawn by ``randint`` on the card from each step key)
    replayed 3 times is bitwise the eager rounds, and a warm round copies
    nothing from the host."""
    from hyperopt_tpu_torch import random as R
    from hyperopt_tpu_torch.models import transformer as TT
    from hyperopt_tpu_torch.pbt import compile_pbt

    lm = TT.TinyLM(vocab=16, d_model=16, n_heads=2, n_layers=1, max_len=16)
    params = TT.init_population(lm, 8, R.key(0))
    state = (params, {k: torch.zeros_like(v) for k, v in params.items()})
    runner = compile_pbt(TT.make_pbt_train_fn(lm, 16, 16, 16), state,
                         {"lr": (1e-3, 1.0), "wd": (1e-7, 1e-2)}, pop_size=8, exploit_every=3,
                         n_rounds=3)
    out = runner(seed=0)
    assert len(runner._graph) == 1
    eager = runner._run(0, None, eager=True)
    assert np.array_equal(eager["loss_history"], out["loss_history"])
    assert np.array_equal(eager["log_hypers"], out["log_hypers"])
    assert all(torch.equal(a, b) for a, b in zip(eager["state"][0].values(),
                                                 out["state"][0].values()))
    runner._round_index.zero_()
    _sync_checked(runner._round)
