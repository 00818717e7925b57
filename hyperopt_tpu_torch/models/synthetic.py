"""Synthetic spaces and objectives of the PyTorch port (counterparts of
:mod:`hyperopt_tpu.models.synthetic`, built with the port's ``hp``).

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
    "budgeted_quadratic_fn",
    "budgeted_quadratic_space",
    "cond_tune_objective",
    "cond_tune_space",
    "mixed_space",
    "mixed_space_fn",
    "mixed_space_fn_torch",
    "mlp_tune_objective",
    "mlp_tune_space",
]


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
