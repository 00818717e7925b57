"""Synthetic spaces and objectives of the PyTorch port (counterparts of
:mod:`hyperopt_tpu.models.synthetic`, built with the port's ``hp``).

``DOMAINS``/``battery`` are the domain battery: ten objectives over
their spaces (``quadratic1`` ... ``trap15``, among them ``branin_fn`` and
``hartmann6_fn``), each with its global minimum and the best loss a
competent optimizer reaches within a number of evaluations (``targets``).
``mixed_space``/``mixed_space_fn`` are the throughput benchmark's space
and host objective; ``mixed_space_fn_torch`` is the same objective over
tensors, for the compiled loop; ``mlp_tune_*`` and ``cond_tune_*`` are
its trainable objectives (:class:`~hyperopt_tpu_torch.device_loop.
TrainableObjective`), whose data come from the port's threefry, so they
are the reference's up to float rounding.  ``budgeted_quadratic_*`` is
the multi-fidelity objective of the host schedulers
(:mod:`hyperopt_tpu_torch.hyperband`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import hp
from .. import random as R

__all__ = [
    "DOMAINS",
    "SyntheticDomain",
    "battery",
    "branin_fn",
    "budgeted_quadratic_fn",
    "budgeted_quadratic_space",
    "cond_tune_objective",
    "cond_tune_space",
    "hartmann6_fn",
    "mixed_space",
    "mixed_space_fn",
    "mixed_space_fn_torch",
    "mlp_tune_objective",
    "mlp_tune_space",
]


class SyntheticDomain:
    """One benchmark objective: fn over a space, plus test thresholds.

    ``fn`` takes the materialized config (scalar or dict, matching what the
    space evaluates to).  ``targets`` maps a number of evaluations to the
    loss a competent optimizer should reach within them (loose test
    thresholds).
    """

    def __init__(self, name, fn, space, global_min, targets):
        self.name = name
        self.fn = fn
        self.space = space
        self.global_min = global_min
        self.targets = targets  # {n_evals: loss threshold}

    def make_space(self):
        return self.space()

    def __repr__(self):
        return f"SyntheticDomain({self.name})"


# -- simple 1-D -------------------------------------------------------------


def _quadratic1_fn(x):
    return (x - 3.0) ** 2


def _q1_lognormal_fn(x):
    return max(0.0, min((x - 3.0) ** 2 / 2.0, 10.0))


def _q1_choice_fn(cfg):
    if cfg["case"] == 1:
        return (cfg["x"] - 1.0) ** 2
    return 0.5 * (cfg["x"] + 2.5) ** 2 + 0.25


def _n_arms_fn(arm):
    return [0.0, 0.25, 0.5, 0.75, 1.0][arm]


# -- classic BBO ------------------------------------------------------------


def branin_fn(cfg):
    """Branin-Hoo; global min 0.397887 at (-pi, 12.275), (pi, 2.275),
    (9.42478, 2.475)."""
    x1, x2 = cfg["x1"], cfg["x2"]
    a = 1.0
    b = 5.1 / (4 * math.pi**2)
    c = 5.0 / math.pi
    r = 6.0
    s = 10.0
    t = 1.0 / (8 * math.pi)
    return (
        a * (x2 - b * x1**2 + c * x1 - r) ** 2 + s * (1 - t) * math.cos(x1) + s
    )


_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H6_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ]
)
_H6_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ]
)


def hartmann6_fn(cfg):
    """Hartmann-6; global min -3.32237."""
    x = np.array([cfg[f"x{i}"] for i in range(6)])
    inner = np.sum(_H6_A * (x - _H6_P) ** 2, axis=1)
    return float(-np.sum(_H6_ALPHA * np.exp(-inner)))


def _rosenbrock2_fn(cfg):
    x, y = cfg["x"], cfg["y"]
    return (1 - x) ** 2 + 100.0 * (y - x**2) ** 2


# -- conditional / gnarly ---------------------------------------------------


def _gauss_wave2_fn(cfg):
    """Conditional objective: branch 1 can beat branch 0 only if its
    amplitude is tuned -- exercises choice + nested continuous."""
    x = cfg["x"]
    base = math.exp(-((x / 10.0) ** 2))
    if cfg["kind"] == "raw":
        return -base
    return -base * cfg["amp"]


def _many_dists_fn(cfg):
    """Smoke objective over every distribution family."""
    t = 0.0
    t += (cfg["a_u"] - 1.0) ** 2 / 25.0
    t += (cfg["b_qu"] - 2.0) ** 2 / 25.0
    t += (math.log(max(cfg["c_lu"], 1e-12)) + 1.0) ** 2 / 9.0
    t += (cfg["d_n"] / 2.0) ** 2
    t += (cfg["e_qn"] / 4.0) ** 2
    t += (math.log(max(cfg["f_ln"], 1e-12)) / 2.0) ** 2
    t += abs(cfg["g_ri"] - 3) / 10.0
    branch = cfg["branch"]
    if branch["which"] == 0:
        t += (branch["inner_u"] - 0.5) ** 2
    elif branch["which"] == 1:
        t += 0.1 + (math.log(max(branch["inner_lu"], 1e-12)) - 0.0) ** 2 / 9.0
    else:
        t += 0.05 + abs(branch["inner_c"] - 1) * 0.2
    return t


def _space_quadratic1():
    return hp.uniform("x", -5, 5)


def _space_q1_lognormal():
    return hp.lognormal("x", 0.0, 1.0)


def _space_q1_choice():
    return hp.choice(
        "p",
        [
            {"case": 1, "x": hp.uniform("x1", -5, 5)},
            {"case": 2, "x": hp.uniform("x2", -5, 5)},
        ],
    )


def _space_n_arms():
    return hp.choice("arm", [0, 1, 2, 3, 4])


def _space_branin():
    return {"x1": hp.uniform("x1", -5, 10), "x2": hp.uniform("x2", 0, 15)}


def _space_hartmann6():
    return {f"x{i}": hp.uniform(f"x{i}", 0, 1) for i in range(6)}


def _space_rosenbrock2():
    return {"x": hp.uniform("x", -2, 2), "y": hp.uniform("y", -1, 3)}


def _space_gauss_wave2():
    return hp.choice(
        "curve",
        [
            {"kind": "raw", "x": hp.uniform("x_raw", -20, 20)},
            {
                "kind": "amp",
                "x": hp.uniform("x_amp", -20, 20),
                "amp": hp.uniform("amp", 0.5, 1.5),
            },
        ],
    )


def _trap15_fn(cfg):
    """Deceptive multi-basin trap (round-3 ATPE stall battery).

    Each of 15 dims has a BROAD gentle basin at x=-2 (floor 0.18) and a
    NARROW basin reaching 0 at x=+3 (catchment ~1.7% of the range):
    posterior exploitation converges into the broad basin; leaving it
    requires continued wide-exploration draws.  Built to exercise the
    stalled-experiment adaptation levers; the measured verdict
    (BASELINE.md round 3) is that plain TPE's adaptive-Parzen PRIOR
    COMPONENT -- weight ~1/(n_below+1) in every below-model -- already
    supplies that exploration, so explicit stall levers add little.
    """
    xs = np.array([cfg[f"t{i}"] for i in range(15)])
    broad = 0.18 + (xs + 2.0) ** 2 / 30.0
    narrow = 25.0 * (xs - 3.0) ** 2
    return float(np.mean(np.minimum(broad, narrow)))


def _space_trap15():
    return {f"t{i}": hp.uniform(f"t{i}", -5.0, 5.0) for i in range(15)}


def _space_many_dists():
    return {
        "a_u": hp.uniform("a_u", -5, 5),
        "b_qu": hp.quniform("b_qu", -5, 5, 0.5),
        "c_lu": hp.loguniform("c_lu", -4, 2),
        "d_n": hp.normal("d_n", 0, 2),
        "e_qn": hp.qnormal("e_qn", 0, 4, 1),
        "f_ln": hp.lognormal("f_ln", 0, 1),
        "g_ri": hp.randint("g_ri", 10),
        "branch": hp.choice(
            "branch",
            [
                {"which": 0, "inner_u": hp.uniform("inner_u", 0, 1)},
                {"which": 1, "inner_lu": hp.loguniform("inner_lu", -3, 3)},
                {"which": 2, "inner_c": hp.pchoice(
                    "inner_c", [(0.2, 0), (0.5, 1), (0.3, 2)]
                )},
            ],
        ),
    }


DOMAINS = {
    d.name: d
    for d in [
        SyntheticDomain(
            "quadratic1", _quadratic1_fn, _space_quadratic1, 0.0,
            {80: 0.3},
        ),
        SyntheticDomain(
            "q1_lognormal", _q1_lognormal_fn, _space_q1_lognormal, 0.0,
            {80: 0.5},
        ),
        SyntheticDomain(
            "q1_choice", _q1_choice_fn, _space_q1_choice, 0.0,
            {80: 0.35},
        ),
        SyntheticDomain(
            "n_arms", _n_arms_fn, _space_n_arms, 0.0,
            {30: 0.0},
        ),
        SyntheticDomain(
            "branin", branin_fn, _space_branin, 0.397887,
            {100: 1.2},
        ),
        SyntheticDomain(
            "hartmann6", hartmann6_fn, _space_hartmann6, -3.32237,
            {150: -1.2},
        ),
        SyntheticDomain(
            "rosenbrock2", _rosenbrock2_fn, _space_rosenbrock2, 0.0,
            {120: 6.0},
        ),
        SyntheticDomain(
            "gauss_wave2", _gauss_wave2_fn, _space_gauss_wave2, -1.5,
            {100: -1.0},
        ),
        SyntheticDomain(
            "many_dists", _many_dists_fn, _space_many_dists, 0.0,
            {100: 1.5},
        ),
        SyntheticDomain(
            "trap15", _trap15_fn, _space_trap15, 0.0,
            {200: 0.30},
        ),
    ]
}


def battery(names=None):
    """The canonical domain list, or the named ones in order."""
    if names is None:
        return list(DOMAINS.values())
    return [DOMAINS[n] for n in names]


def mixed_space(n_uniform=8, n_loguniform=4, n_quniform=2, n_randint=3, n_choice=3):
    """A D-dim mixed continuous/categorical flat space (defaults: 20-dim,
    the throughput benchmark configuration)."""
    space = {}
    for i in range(n_uniform):
        space[f"u{i}"] = hp.uniform(f"u{i}", -5, 5)
    for i in range(n_loguniform):
        space[f"lu{i}"] = hp.loguniform(f"lu{i}", -5, 2)
    for i in range(n_quniform):
        space[f"qu{i}"] = hp.quniform(f"qu{i}", 0, 20, 1)
    for i in range(n_randint):
        space[f"ri{i}"] = hp.randint(f"ri{i}", 8)
    for i in range(n_choice):
        space[f"ch{i}"] = hp.choice(f"ch{i}", list(range(5)))
    return space


def mixed_space_fn(cfg):
    """Cheap separable loss over ``mixed_space`` (objective cost ~0, so
    suggest dominates)."""
    t = 0.0
    for k, v in cfg.items():
        if k.startswith("lu"):
            t += (math.log(max(v, 1e-12))) ** 2 / 50.0
        elif k.startswith("u"):
            t += (v - 1.0) ** 2 / 50.0
        elif k.startswith("qu"):
            t += abs(v - 10.0) / 100.0
        elif k.startswith("ri") or k.startswith("ch"):
            t += 0.02 * (v % 3)
    return t


def budgeted_quadratic_fn(cfg, budget):
    """The schedulers' multi-fidelity objective: a quadratic whose
    observation noise shrinks with the budget, so promotion must pick
    good configs through rung-0 noise.  Deterministic per ``(config,
    budget)``: the noise comes from a numpy generator seeded by ``x``."""
    rng = np.random.default_rng(int(1e6 * (cfg["x"] % 1)) % 2**31)
    return (cfg["x"] - 3.0) ** 2 + float(rng.normal(0.0, 1.0 / budget))


def budgeted_quadratic_space():
    return {"x": hp.uniform("x", -10.0, 10.0)}


def mixed_space_fn_torch(cfg):
    """``mixed_space_fn`` over ``[batch]`` value tensors (the reference's
    ``mixed_space_fn_jax``): the compiled loop's objective on
    ``mixed_space``.  Categorical/randint dims arrive as float indices."""
    t = 0.0
    for k, v in cfg.items():
        if k.startswith("lu"):
            t = t + torch.log(torch.clamp(v, min=1e-12)) ** 2 / 50.0
        elif k.startswith("u"):
            t = t + (v - 1.0) ** 2 / 50.0
        elif k.startswith("qu"):
            t = t + torch.abs(v - 10.0) / 100.0
        elif k.startswith("ri") or k.startswith("ch"):
            t = t + 0.02 * (torch.round(v).to(torch.int32) % 3)
    return t


def mlp_tune_space():
    """The MLP-tuning search space (the reference's ``mlp_tune_space``):
    the training dynamics of a fixed-architecture regressor."""
    return {
        "lr": hp.loguniform("lr", math.log(1e-3), math.log(1.0)),
        "momentum": hp.uniform("momentum", 0.0, 0.99),
        "wd": hp.loguniform("wd", math.log(1e-6), math.log(1e-2)),
        "init_scale": hp.loguniform("init_scale", math.log(1e-2), math.log(1.0)),
    }


def _regression_data(n_train, in_dim, seed):
    """A cache of the synthetic regression set on each device it is asked
    for: ``X ~ N(0, 1) [n_train, in_dim]``, ``y = tanh(X w) + 0.1 N(0,
    1)``, drawn by the port's threefry from ``key(seed)`` as the reference
    draws them.  The first call on a device makes the tensors there."""
    cache = {}

    def data(device):
        out = cache.get(device)
        if out is None:
            kx, kw, kn = R.split(R.key(seed, device=device), 3).unbind(0)
            x = R.normal(kx, (n_train, in_dim))
            y = torch.tanh(x @ R.normal(kw, (in_dim,))) + 0.1 * R.normal(kn, (n_train,))
            out = cache[device] = (x, y)
        return out

    return data


def _mlp_pieces(n_train, in_dim, hidden, seed):
    """init(key, scale), step(state, lr, momentum, weight decay) and
    loss(state) of the 2-layer tanh regressor trained by full-batch SGD
    with momentum and weight decay; the state is (params, momentum)."""
    data = _regression_data(n_train, in_dim, seed)

    def mse(params, x, y):
        h = torch.tanh(x @ params["w1"] + params["b1"])
        return torch.mean((h @ params["w2"] + params["b2"] - y) ** 2)

    def init(k, scale):
        k1, k2 = R.split(k, 2).unbind(-2)
        params = {
            "w1": scale * R.normal(k1, (in_dim, hidden)),
            "b1": torch.zeros((hidden,), dtype=torch.float32, device=k.device),
            "w2": scale * R.normal(k2, (hidden,)),
            "b2": torch.zeros((), dtype=torch.float32, device=k.device),
        }
        return params, {name: torch.zeros_like(p) for name, p in params.items()}

    def step(state, lr, mu, wd):
        params, momentum = state
        x, y = data(params["w1"].device)
        grads = torch.func.grad(mse)(params, x, y)
        momentum = {n: mu * momentum[n] - lr * (grads[n] + wd * params[n]) for n in params}
        return {n: params[n] + momentum[n] for n in params}, momentum

    def loss(state):
        params, _ = state
        return mse(params, *data(params["w1"].device))

    return init, step, loss


def mlp_tune_objective(n_epochs=8, n_train=256, in_dim=8, hidden=32, seed=0):
    """End-to-end MLP tuning as a :class:`~hyperopt_tpu_torch.device_loop.
    TrainableObjective` (the reference's ``mlp_tune_objective``): each
    trial initializes its own 2-layer MLP (tanh head) at its
    ``init_scale``, trains ``n_epochs`` full-batch SGD+momentum epochs on
    a fixed synthetic regression set and reports the final MSE.  Pair
    with :func:`mlp_tune_space`."""
    from ..device_loop import TrainableObjective

    init, step, loss = _mlp_pieces(n_train, in_dim, hidden, seed)

    def init_fn(k, cfg):
        return init(k, cfg["init_scale"])

    def step_fn(state, cfg, epoch):
        del epoch  # constant-lr schedule
        return step(state, cfg["lr"], cfg["momentum"], cfg["wd"])

    def loss_fn(state, cfg):
        return loss(state)

    return TrainableObjective(init_fn, step_fn, loss_fn, n_epochs=n_epochs)


def cond_tune_space():
    """A conditional training space (the reference's ``cond_tune_space``):
    the regularizer family on the outer choice, a boost behind a second
    choice inside the momentum branch.  Off-branch dims reach the
    objective as 0.0."""
    return {
        "ct_lr": hp.loguniform("ct_lr", math.log(1e-3), math.log(1.0)),
        "reg": hp.choice("ct_reg", [
            {"kind": "none"},
            {"kind": "l2", "wd": hp.loguniform("ct_wd", math.log(1e-6), math.log(1e-1))},
            {
                "kind": "momentum",
                "mu": hp.uniform("ct_mu", 0.0, 0.99),
                "nest": hp.choice("ct_nest", [
                    {"boost": "off"},
                    {"boost": "on", "extra": hp.uniform("ct_extra", 0.0, 1.0)},
                ]),
            },
        ]),
    }


def cond_tune_objective(n_epochs=4, n_train=64, in_dim=4, hidden=8, seed=0):
    """The conditional-space twin of :func:`mlp_tune_objective` (the
    reference's ``cond_tune_objective``; pair with
    :func:`cond_tune_space`): it reads the off-branch dims ungated, which
    is right only because the compiled loop pins them to 0.0, and its
    ``init_fn`` takes the ``active`` masks (the l2 branch starts from a
    smaller head)."""
    from ..device_loop import TrainableObjective

    init, step, loss = _mlp_pieces(n_train, in_dim, hidden, seed)

    def init_fn(k, cfg, active):
        return init(k, torch.where(active["ct_wd"], 0.25, 0.5))

    def step_fn(state, cfg, epoch):
        del epoch
        lr = cfg["ct_lr"] * (1.0 + cfg["ct_extra"])
        return step(state, lr, cfg["ct_mu"], cfg["ct_wd"])

    def loss_fn(state, cfg):
        return loss(state)

    return TrainableObjective(init_fn, step_fn, loss_fn, n_epochs=n_epochs)
