"""The port's TinyLM population model (``hyperopt_tpu_torch.models.
transformer``) against the reference's flax model on the CPU.

Every parity case carries the reference's weights over through
``convert.tinylm_params_from_numpy`` and feeds both packages the same
tokens (``synthetic_token_batch`` is bitwise the reference's).  The
tolerances, from the float32 rounding of two implementations of the same
layers (XLA's and PyTorch's matrix products, LayerNorm variances and
softmax sums):

* LOGIT_ATOL 1e-5 on logits of magnitude about 4 (measured 1.7e-6);
* LOSS_RTOL 1e-5 on losses, single steps and trained ones alike
  (measured 3e-7 after 3 steps, 6e-7 after 12 PBT steps);
* PARAM_ATOL 1e-6 on parameters and momenta after one step (measured
  1.2e-7).

Initialization draws flax's distributions from the port's threefry, not
flax's bits: it is held by statistics over 64 members (INIT_SIGMAS).
Sizes are the reference tests' small ones: vocab 16, d_model 16, two
heads, one layer, sequences of 16.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from hyperopt_tpu.models import transformer as JT
from hyperopt_tpu_torch import convert
from hyperopt_tpu_torch import random as R
from hyperopt_tpu_torch.models import _population as TP
from hyperopt_tpu_torch.models import transformer as TT
from hyperopt_tpu_torch.parallel.mesh import RankMesh, virtual_mesh

KW = dict(vocab=16, d_model=16, n_heads=2, n_layers=1, max_len=16)
LOGIT_ATOL = 1e-5
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-6
# init statistics: each leaf's pooled mean within INIT_SIGMAS standard
# errors of the difference of two means, its std within INIT_SIGMAS
# standard errors of a std ratio (1/sqrt(N) for N draws)
INIT_SIGMAS = 5.0
P_INIT = 64


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def ref():
    """The reference model and a 64-member population of its init."""
    jm = JT.TinyLM(**KW)
    pop = jax.jit(lambda k: JT.init_population(jm, P_INIT, k, seq_len=16))(jax.random.key(0))
    return jm, _np(pop)


@pytest.fixture(scope="module")
def tokens():
    return JT.synthetic_token_batch(jax.random.key(1), 16, 16, 16, n_deltas=8)


def _members(pop, n):
    return jax.tree.map(lambda x: x[:n], pop)


def _port(pop):
    return convert.tinylm_params_from_numpy(pop, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("batch,seq,vocab,n_deltas", [(16, 16, 16, 8), (32, 32, 32, 8),
                                                      (5, 9, 7, 6)])
def test_synthetic_token_batch_is_bitwise(seed, batch, seq, vocab, n_deltas):
    want = np.asarray(JT.synthetic_token_batch(jax.random.key(seed), batch, seq, vocab,
                                               n_deltas=n_deltas))
    got = TT.synthetic_token_batch(R.key(seed), batch, seq, vocab, n_deltas=n_deltas)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_convert_round_trip(ref):
    """Every flax leaf lands on the port's parameter of the same role and
    shape, with or without the population axis; undoing each layout
    change gives the flax arrays back."""
    jm, pop = ref
    tm = TT.TinyLM(**KW)
    conv = _port(pop)
    assert {n: tuple(v.shape[1:]) for n, v in conv.items()} == {
        n: tuple(p.shape) for n, p in tm.named_parameters()}
    one = convert.tinylm_params_from_numpy(jax.tree.map(lambda x: x[3], pop), device="cpu")
    for n, v in conv.items():
        assert torch.equal(v[3], one[n]), n
    blk = pop["Block_0"]
    q = conv["blocks.0.query.weight"].numpy()
    np.testing.assert_array_equal(np.swapaxes(q, -1, -2).reshape(blk["SelfAttention_0"]
                                  ["query"]["kernel"].shape), blk["SelfAttention_0"]["query"]
                                  ["kernel"])
    o = conv["blocks.0.out.weight"].numpy()
    np.testing.assert_array_equal(np.swapaxes(o, -1, -2).reshape(
        blk["SelfAttention_0"]["out"]["kernel"].shape), blk["SelfAttention_0"]["out"]["kernel"])
    np.testing.assert_array_equal(np.swapaxes(conv["head.weight"].numpy(), -1, -2),
                                  pop["Dense_0"]["kernel"])
    np.testing.assert_array_equal(conv["tok_emb.weight"].numpy(), pop["Embed_0"]["embedding"])
    np.testing.assert_array_equal(conv["ln_f.weight"].numpy(), pop["LayerNorm_0"]["scale"])


@pytest.mark.parametrize("member", [0, 1, 2])
def test_forward_logits(ref, tokens, member):
    jm, pop = ref
    params = jax.tree.map(lambda x: x[member], pop)
    want = np.asarray(jm.apply({"params": params}, tokens))
    tm = TT.TinyLM(**KW)
    got = torch.func.functional_call(tm, convert.tinylm_params_from_numpy(params, device="cpu"),
                                     (_t(tokens, torch.int64),))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=LOGIT_ATOL)


def test_next_token_loss(ref, tokens):
    jm, pop = ref
    params = jax.tree.map(lambda x: x[5], pop)
    want = float(JT._next_token_loss_fn(jm)(params, tokens))
    got = TT._next_token_loss_fn(TT.TinyLM(**KW))(
        convert.tinylm_params_from_numpy(params, device="cpu"), _t(tokens, torch.int64))
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)


def test_member_step_params_momentum_and_loss(ref, tokens):
    """One member's step from a nonzero momentum: the same SGD rule
    (``m' = 0.9 m + g``, ``p' = p - lr (m' + wd p)``)."""
    jm, pop = ref
    params = jax.tree.map(lambda x: x[2], pop)
    momentum = jax.tree.map(lambda x: 0.01 * x, params)
    step = jax.jit(lambda p, m, t: JT._member_train_step(JT._next_token_loss_fn(jm), p, m,
                                                         0.3, 1e-3, t))
    jp, jmom, jloss = _np(step(params, momentum, tokens))
    tp, tmom, tloss = TP.member_train_step(
        TT._next_token_loss_fn(TT.TinyLM(**KW)),
        convert.tinylm_params_from_numpy(params, device="cpu"),
        convert.tinylm_params_from_numpy(_np(momentum), device="cpu"),
        torch.tensor(0.3), torch.tensor(1e-3), _t(tokens, torch.int64))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    for want, got in ((jp, tp), (jmom, tmom)):
        want = convert.tinylm_params_from_numpy(want, device="cpu")
        for n in want:
            np.testing.assert_allclose(got[n].detach().numpy(), want[n].numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=n)


def test_population_step_of_four(ref, tokens):
    """The vmapped step against the reference's jitted one: four members
    with their own lr and wd, three steps."""
    jm, pop = ref
    jp = _members(pop, 4)
    jmom = jax.tree.map(np.zeros_like, jp)
    lr = np.array([0.3, 0.1, 0.03, 0.01], np.float32)
    wd = np.array([1e-5, 1e-4, 1e-3, 1e-2], np.float32)
    jstep = JT.make_population_train_step(jm)
    tstep = TT.make_population_train_step(TT.TinyLM(**KW), device="cpu")
    tp, tmom = _port(jp), _port(jmom)
    ttok = _t(tokens, torch.int64)
    for _ in range(3):
        jp, jmom, jloss = _np(jstep(jp, jmom, lr, wd, tokens))
        tp, tmom, tloss = tstep(tp, tmom, _t(lr), _t(wd), ttok)
        np.testing.assert_allclose(tloss.detach().numpy(), jloss, rtol=LOSS_RTOL)
    want = _port(jp)
    for n in want:
        np.testing.assert_allclose(tp[n].detach().numpy(), want[n].numpy(), rtol=0,
                                   atol=10 * PARAM_ATOL, err_msg=n)
    assert len(np.unique(np.round(jloss, 6))) > 1  # the members really differ


def _objective_start(seed=0):
    """The reference objectives' model, initial parameters and tokens
    (``key(seed)`` split in two), carried into the port."""
    jm = JT.TinyLM(**KW)
    init_key, data_key = jax.random.split(jax.random.key(seed))
    p0 = _np(jm.init(init_key, jnp.zeros((1, 15), jnp.int32))["params"])
    ttok = TT.synthetic_token_batch(R.split(R.key(seed))[1], 16, 16, 16, n_deltas=8)
    np.testing.assert_array_equal(
        ttok.numpy(), np.asarray(JT.synthetic_token_batch(data_key, 16, 16, 16, n_deltas=8)))
    return TT.TinyLM(**KW), convert.tinylm_params_from_numpy(p0, device="cpu"), ttok


def test_device_objective_builder_on_carried_weights():
    """``device_objective``'s body on the reference's initial weights: the
    losses after 3 steps at four (lr, wd)."""
    cfg = {"lr": np.array([0.3, 0.1, 0.03, 1e-3], np.float32),
           "wd": np.array([1e-5, 1e-4, 1e-3, 1e-2], np.float32)}
    want = np.asarray(JT.device_objective(n_steps=3)({k: jnp.asarray(v) for k, v in cfg.items()}))
    tm, tp0, ttok = _objective_start()
    got = TT._device_objective(tm, tp0, ttok, 3)({k: _t(v) for k, v in cfg.items()})
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL)


def test_budget_objective_builder_on_carried_weights():
    """``budget_objective``'s body: one program per budget, each the
    reference's loss; a repeated budget reuses its program."""
    jfn = JT.budget_objective()
    tm, tp0, ttok = _objective_start()
    tfn = TT._budget_objective(tm, tp0, ttok)
    for cfg, budget in (({"lr": 0.1, "wd": 1e-4}, 1), ({"lr": 0.3, "wd": 1e-5}, 3),
                        ({"lr": 0.05, "wd": 1e-3}, 3)):
        got = tfn(cfg, budget)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, jfn(cfg, budget), rtol=LOSS_RTOL)


def test_budget_objective_is_thread_safe():
    """Eight threads call one budget objective at once, as the
    schedulers' workers do (``functional_call`` swaps tensors into the
    shared module, so the calls must take turns): each result is the
    sequential call's, and no call raises."""
    import sys
    import threading

    tm, tp0, ttok = _objective_start()
    fn = TT._budget_objective(tm, tp0, ttok)
    jobs = [({"lr": 0.02 * (i + 1), "wd": 1e-4}, 1 + i % 3) for i in range(8)]
    want = [fn(cfg, b) for cfg, b in jobs]
    got, errors = [None] * len(jobs), []

    def work(i):
        try:
            got[i] = fn(*jobs[i])
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_init_statistics_match_the_reference(ref):
    """Each leaf's mean and std over 64 members: flax's family and scale
    (lecun normal kernels, unit-fan-in embeddings, zero biases, unit norm
    scales), drawn from the port's own keys."""
    _, pop = ref
    want = _port(pop)
    got = TT.init_population(TT.TinyLM(**KW), P_INIT, R.key(0), device="cpu")
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n]
        assert g.shape == w.shape and g.dtype == torch.float32, n
        w, g = w.numpy().astype(np.float64), g.numpy().astype(np.float64)
        if w.std() == 0:  # zeros and ones
            np.testing.assert_array_equal(g, w, err_msg=n)
            continue
        N = w.size
        assert abs(g.mean() - w.mean()) <= INIT_SIGMAS * w.std() * np.sqrt(2.0 / N), n
        assert abs(g.std() / w.std() - 1.0) <= INIT_SIGMAS / np.sqrt(N), n
        # a truncated normal stays within two of its unscaled stds
        assert np.abs(g).max() <= np.abs(w).max() * 1.05 + 1e-6 or "emb" in n, n
    again = TT.init_population(TT.TinyLM(**KW), P_INIT, R.key(0), device="cpu")
    assert all(torch.equal(again[n], got[n]) for n in got)  # seed-deterministic


def test_compile_pbt_on_tinylm_from_carried_state(ref):
    """The port's ``compile_pbt`` (eager, on the CPU) on 8 TinyLMs carried
    from the reference's init: every round's losses within LOSS_RTOL,
    and the same exploit decisions (the log-space hypers bitwise)."""
    from hyperopt_tpu.pbt import compile_pbt as j_compile_pbt
    from hyperopt_tpu_torch.pbt import compile_pbt

    jm, pop = ref
    P = 8
    jp = _members(pop, P)
    bounds = {"lr": (1e-3, 1.0), "wd": (1e-7, 1e-2)}
    opts = dict(pop_size=P, exploit_every=3, n_rounds=4)
    j_out = j_compile_pbt(JT.make_pbt_train_fn(jm, 16, 16, 16),
                          (jp, jax.tree.map(np.zeros_like, jp)), bounds, **opts)(seed=5)
    tp = _port(jp)
    t_out = compile_pbt(TT.make_pbt_train_fn(TT.TinyLM(**KW), 16, 16, 16),
                        (tp, TP.zeros_like(tp)), bounds, device="cpu", **opts)(seed=5)
    np.testing.assert_allclose(t_out["loss_history"], np.asarray(j_out["loss_history"]),
                               rtol=LOSS_RTOL)
    for n in bounds:
        np.testing.assert_array_equal(t_out["hypers"][n], np.asarray(j_out["hypers"][n]))
    assert t_out["best_index"] == j_out["best_index"]
    assert t_out["loss_history"][-1].min() < t_out["loss_history"][0].min()


def test_sharding_is_refused():
    """What ``mesh=`` still refuses: a data axis over processes (its
    gradient all-reduce would sit inside the captured step), a mesh that
    is not a RankMesh, an axis the mesh lacks, and widths that do not
    divide (the reference's sharding constraints refuse those too)."""
    model = TT.TinyLM(**KW)
    with pytest.raises(NotImplementedError, match="item 15c, part 6"):
        TT.make_population_train_step(model, mesh=RankMesh((2, 2), ("trial", "cand"), range(4)),
                                      device="cpu")
    with pytest.raises(TypeError, match="RankMesh"):
        TT.population_objective(mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="trial_axis 'pop' is not an axis"):
        TT.make_population_train_step(model, mesh=virtual_mesh(2, "trial"), trial_axis="pop",
                                      data_axis=None, device="cpu")
    step = TT.make_population_train_step(model, mesh=virtual_mesh((2, 3), ("trial", "cand")),
                                         device="cpu")
    pop = TP.init_members(model, 4, R.key(0), "cpu")
    tokens = TT.synthetic_token_batch(R.key(1), 16, 16, 16, n_deltas=8)
    with pytest.raises(ValueError, match="data batch's dimension 0 \\(16\\) must divide"):
        step(pop, TP.zeros_like(pop), torch.ones(4), torch.ones(4), tokens)


def test_population_step_on_a_mesh(ref, tokens):
    """``mesh=virtual_mesh((2, 4), ("trial", "cand"))`` places four members
    on two trial ranks and the 16 sequences on four data ranks, as the
    reference's ``test_transformer_population_sharded_step`` does: the
    step is bitwise the step without a mesh, and both hold the
    reference's unsharded step within the file's tolerances."""
    jm, pop = ref
    jp = _members(pop, 4)
    jmom = jax.tree.map(np.zeros_like, jp)
    lr = np.array([0.3, 0.1, 0.03, 0.01], np.float32)
    wd = np.full((4,), 1e-5, np.float32)
    jstep = JT.make_population_train_step(jm)
    model = TT.TinyLM(**KW)
    placed = TT.make_population_train_step(
        model, mesh=virtual_mesh((2, 4), ("trial", "cand")), device="cpu")
    plain = TT.make_population_train_step(model, device="cpu")
    tp = pp = _port(jp)
    tmom = pmom = _port(jmom)
    ttok = _t(tokens, torch.int64)
    for _ in range(2):
        jp, jmom, jloss = _np(jstep(jp, jmom, lr, wd, tokens))
        tp, tmom, tloss = placed(tp, tmom, _t(lr), _t(wd), ttok)
        pp, pmom, ploss = plain(pp, pmom, _t(lr), _t(wd), ttok)
        assert torch.equal(tloss, ploss)
        np.testing.assert_allclose(tloss.detach().numpy(), jloss, rtol=LOSS_RTOL)
    want = _port(jp)
    for n in want:
        assert torch.equal(tp[n], pp[n]) and torch.equal(tmom[n], pmom[n]), n
        np.testing.assert_allclose(tp[n].detach().numpy(), want[n].numpy(), rtol=0,
                                   atol=10 * PARAM_ATOL, err_msg=n)
    # the fmin objective on a (1, 4) mesh: the same losses, bit for bit
    cfg = {"lr": 0.3, "wd": 1e-5}
    on_mesh = TT.population_objective(n_steps=2, device="cpu",
                                      mesh=virtual_mesh((1, 4), ("trial", "cand")))
    assert on_mesh(cfg) == TT.population_objective(n_steps=2, device="cpu")(cfg)


def test_population_objective_trains(ref):
    """The ``fmin`` objective: a sane lr beats a vanishing one (the
    reference's own check), deterministic per config."""
    obj = TT.population_objective(n_steps=4, device="cpu")
    good, bad = obj({"lr": 0.3, "wd": 1e-5}), obj({"lr": 1e-4, "wd": 1e-5})
    assert np.isfinite(good) and np.isfinite(bad) and good < bad
    assert obj({"lr": 0.3, "wd": 1e-5}) == good


@pytest.mark.slow
def test_compile_fmin_over_device_objective_matches_the_reference():
    """The whole slice on the CPU: ``compile_fmin`` over the TinyLM
    objective, the port's on the reference's initial weights, 24 trials
    in batches of 4 (the reference's ``test_device_loop`` protocol)."""
    from hyperopt_tpu.device_loop import compile_fmin as j_compile_fmin
    from hyperopt_tpu_torch.device_loop import compile_fmin

    j_out = j_compile_fmin(JT.device_objective(n_steps=3), JT.hpo_space(), max_evals=24,
                           batch_size=4)(seed=0)
    tm, tp0, ttok = _objective_start()
    runner = compile_fmin(TT._device_objective(tm, tp0, ttok, 3), TT.hpo_space(),
                          max_evals=24, batch_size=4, device="cpu")
    t_out = runner(seed=0)
    np.testing.assert_allclose(t_out["losses"], np.asarray(j_out["losses"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(t_out["best_loss"], float(j_out["best_loss"]), rtol=LOSS_RTOL)
    assert t_out["best_loss"] < np.max(t_out["losses"]) - 0.1
    np.testing.assert_array_equal(runner(seed=0)["losses"], t_out["losses"])


@pytest.mark.slow
def test_compile_sha_on_tinylm_matches_the_reference(ref):
    """``compile_sha`` on 8 TinyLMs (eta 2, 2 steps per rung) carried from
    the reference's init: every rung's best loss within LOSS_RTOL, the
    same winner and its hypers."""
    from hyperopt_tpu.hyperband import compile_sha as j_compile_sha
    from hyperopt_tpu_torch.hyperband import compile_sha

    jm, pop = ref
    jp = _members(pop, 8)
    bounds = {"lr": (1e-3, 1.0), "wd": (1e-7, 1e-2)}
    opts = dict(n_configs=8, eta=2, steps_per_rung=2)
    j_out = j_compile_sha(JT.make_pbt_train_fn(jm, 16, 16, 16),
                          (jp, jax.tree.map(np.zeros_like, jp)), bounds, **opts)(seed=3)
    tp = _port(jp)
    t_out = compile_sha(TT.make_pbt_train_fn(TT.TinyLM(**KW), 16, 16, 16),
                        (tp, TP.zeros_like(tp)), bounds, device="cpu", **opts)(seed=3)
    for tr, jr in zip(t_out["rungs"], j_out["rungs"]):
        assert (tr["n"], tr["steps"]) == (jr["n"], jr["steps"])
        np.testing.assert_allclose(tr["best_loss"], jr["best_loss"], rtol=LOSS_RTOL)
    assert t_out["best_index"] == int(j_out["best_index"])
    assert t_out["best_hypers"] == pytest.approx(j_out["best_hypers"], rel=1e-6)
