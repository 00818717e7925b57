"""Tiny decoder-only transformer LM trained as a population on the card.

The counterpart of :mod:`hyperopt_tpu.models.transformer`: ``TinyLM`` is
an ``nn.Module`` with the reference's flax layers (pre-LN blocks, causal
self-attention with biased q/k/v/out projections, a 4x GELU MLP, token
and position embeddings, a final LayerNorm and a dense head), and a
population of its parameters -- ``{name: [P, ...]}``, hyperparameters
the only member difference -- trains in one step: ``torch.func.vmap``
over the members of ``torch.func.grad_and_value`` over
``torch.func.functional_call``.

The synthetic task is in-context next-token prediction: every sequence
follows ``x[t+1] = (x[t] + delta) % vocab`` with a per-sequence delta,
drawn by the port's ``randint``, bit for bit the reference's tokens.

Numerics follow flax's order where the choice is free: the query is
scaled by ``1/sqrt(head_dim)`` before ``einsum('...qhd,...khd->
...hqk')``, the causal mask writes ``finfo(float32).min`` before the
softmax, and no fused attention runs (its algorithm choice would change
the bits between an eager and a captured run).  Embeddings are one-hot
products, so their gradient is a matrix product and not a scatter of
atomics.  ``init_population`` draws flax's distributions from the port's
threefry, not flax's bits (:mod:`~hyperopt_tpu_torch.models._population`):
parity with the reference holds on weights carried over by
:func:`hyperopt_tpu_torch.convert.tinylm_params_from_numpy`.

Entry points compute on the card unless the caller passes
``device="cpu"``.  ``mesh=`` places the population step as the
reference's sharding constraints place it
(:func:`~hyperopt_tpu_torch.models._population.on_mesh`): bitwise the
step without a mesh.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import random as R
from ..utils import capture_graph, resolve_device
from ._population import (apply, init_members, member_train_step, on_mesh, sgd_update,
                          zeros_like)

__all__ = [
    "TinyLM",
    "budget_objective",
    "device_objective",
    "hpo_space",
    "init_population",
    "make_pbt_train_fn",
    "make_population_train_step",
    "population_objective",
    "synthetic_token_batch",
]

_NEG = float(torch.finfo(torch.float32).min)


def _embed(tokens, table):
    """``table[tokens]`` as a one-hot product (exact: one nonzero term)."""
    ids = torch.arange(table.shape[0], device=tokens.device)
    return (tokens[..., None] == ids).to(table.dtype) @ table


class _Block(nn.Module):
    """Pre-LN block: causal self-attention, then the 4x GELU MLP."""

    def __init__(self, d_model, n_heads):
        super().__init__()
        self.n_heads = n_heads
        self.ln1 = nn.LayerNorm(d_model, eps=1e-6)
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-6)
        self.fc1 = nn.Linear(d_model, 4 * d_model)
        self.fc2 = nn.Linear(4 * d_model, d_model)

    def _attention(self, h):
        B, T, d = h.shape
        hd = d // self.n_heads
        q, k, v = (proj(h).reshape(B, T, self.n_heads, hd)
                   for proj in (self.query, self.key, self.value))
        q = q / float(np.sqrt(np.float32(hd)))
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        pos = torch.arange(T, device=h.device)
        w = torch.where(pos[:, None] >= pos[None, :], w, _NEG)
        w = torch.softmax(w, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(B, T, d))

    def forward(self, x):
        x = x + self._attention(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class TinyLM(nn.Module):
    """Decoder-only pre-LN transformer LM: ``tokens [B, T]`` (integer)
    -> ``logits [B, T, vocab]`` (the reference's flax ``TinyLM``)."""

    def __init__(self, vocab=64, d_model=32, n_heads=2, n_layers=2, max_len=64):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} must be divisible by n_heads={n_heads}")
        self.tok_emb = nn.Embedding(vocab, d_model)
        self.pos_emb = nn.Embedding(max_len, d_model)
        self.blocks = nn.ModuleList(_Block(d_model, n_heads) for _ in range(n_layers))
        self.ln_f = nn.LayerNorm(d_model, eps=1e-6)
        self.head = nn.Linear(d_model, vocab)

    def forward(self, tokens):
        x = _embed(tokens, self.tok_emb.weight) + self.pos_emb.weight[: tokens.shape[-1]]
        for block in self.blocks:
            x = block(x)
        return self.head(self.ln_f(x))


def synthetic_token_batch(key, batch_size=64, seq_len=32, vocab=64, n_deltas=8):
    """In-context modular-progression sequences, int64 ``[batch, seq_len]``
    on ``key``'s device: each sequence picks ``delta`` in ``[1,
    n_deltas]`` and a start in ``[0, vocab)``; tokens follow ``x[t+1] =
    (x[t] + delta) % vocab``.  Bitwise the reference's tokens for the
    same key."""
    k_delta, k_start = R.split(key).unbind(-2)
    deltas = R.randint(k_delta, (batch_size, 1), 1, n_deltas + 1)
    starts = R.randint(k_start, (batch_size, 1), 0, vocab)
    t = torch.arange(seq_len, device=key.device)[None, :]
    return (starts + deltas * t) % vocab


def _next_token_loss_fn(model):
    """The next-token loss of ``model`` at ``params``: one definition for
    the population steps and the objectives."""

    def loss_fn(params, tokens):
        logits = apply(model, params, tokens[:, :-1])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1))

    return loss_fn


def _population_step(model):
    """``step(params, momentum, lr, wd, tokens)``: the member step mapped
    over the population, the tokens shared."""
    loss_fn = _next_token_loss_fn(model)
    return torch.func.vmap(
        lambda p, m, lr, wd, tokens: member_train_step(loss_fn, p, m, lr, wd, tokens),
        in_dims=(0, 0, 0, 0, None),
    )


def make_population_train_step(model, mesh=None, trial_axis="trial", data_axis="cand",
                               device=None):
    """``train_step(pop_params, pop_momentum, lr [P], wd [P], tokens) ->
    (params, momentum, losses [P])``: one SGD(+momentum, +weight decay)
    next-token step of every member, the losses taken before it.  The
    tensors live on ``device`` (None = the card).  ``mesh`` places the
    population on ``trial_axis`` and the token batch on ``data_axis``, as
    the reference's sharding constraints do
    (:func:`~hyperopt_tpu_torch.models._population.on_mesh`): the same
    step, bit for bit."""
    resolve_device(device)
    return on_mesh(_population_step(model), mesh, trial_axis, data_axis,
                   "make_population_train_step")


def make_pbt_train_fn(model, batch_size=16, seq_len=16, vocab=16):
    """The :func:`hyperopt_tpu_torch.pbt.compile_pbt` contract:
    ``train_fn(state, hypers, key) -> (state, losses [P])`` with ``state
    = (params, momentum)`` populations and hypers ``{"lr": [P], "wd":
    [P]}``.  A fresh token batch is drawn from ``key`` on the card at
    every step (the same for every member)."""
    step = _population_step(model)

    def train_fn(state, hypers, key):
        params, momentum = state
        tokens = synthetic_token_batch(key, batch_size, seq_len, vocab,
                                       n_deltas=min(8, vocab - 1))
        params, momentum, losses = step(params, momentum, hypers["lr"], hypers["wd"], tokens)
        return (params, momentum), losses

    return train_fn


def init_population(model, pop_size, key, seq_len=32, device=None):
    """``pop_size`` members of ``model``'s parameters, ``{name: [P,
    ...]}`` on ``device`` (None = the card), member ``i`` drawn from
    ``split(key, P)[i]`` (``seq_len`` is the reference's dummy input
    length; the shapes here come from the module)."""
    del seq_len
    return init_members(model, pop_size, key, device)


def _setup(batch_size, seq_len, vocab, d_model, n_heads, n_layers, seed, device):
    """The objectives' shared start: the model, one member's initial
    parameters and the fixed token batch, from ``key(seed)`` split in two
    as the reference splits it."""
    dev = resolve_device(device)
    model = TinyLM(vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                   max_len=seq_len)
    init_key, data_key = R.split(R.key(seed, device=dev)).unbind(0)
    tokens = synthetic_token_batch(data_key, batch_size, seq_len, vocab,
                                   n_deltas=min(8, vocab - 1))
    params0 = {k: v[0] for k, v in init_population(model, 1, init_key, device=dev).items()}
    return model, params0, tokens


def _train_from(model, params0, tokens, n_steps):
    """``train(lr, wd) -> loss``: ``n_steps`` SGD steps from ``params0``
    on ``tokens`` and the loss after them (one member; vmappable)."""
    loss_fn = _next_token_loss_fn(model)
    grad_fn = torch.func.grad(loss_fn)

    def train(lr, wd):
        params, momentum = params0, zeros_like(params0)
        for _ in range(n_steps):
            params, momentum = sgd_update(params, momentum, grad_fn(params, tokens), lr, wd)
        return loss_fn(params, tokens)

    return train


def _device_objective(model, params0, tokens, n_steps):
    """``objective(cfg) -> [B]`` over ``cfg["lr"]``/``cfg["wd"]`` ``[B]``:
    every member trains from ``params0`` (vmapped)."""
    train = torch.func.vmap(_train_from(model, params0, tokens, int(n_steps)))

    def objective(cfg):
        return train(cfg["lr"].to(torch.float32), cfg["wd"].to(torch.float32))

    return objective


def device_objective(n_steps=4, batch_size=16, seq_len=16, vocab=16, d_model=16, n_heads=2,
                     n_layers=1, seed=0, device=None):
    """A :func:`~hyperopt_tpu_torch.device_loop.compile_fmin` objective that
    trains a TinyLM per trial inside the captured step: ``objective(cfg)
    -> [B]`` losses over ``{"lr": [B], "wd": [B]}`` tensors.  Every trial
    starts from the same initial parameters (made once, here, on
    ``device``; None = the card), runs ``n_steps`` of SGD+momentum on a
    fixed token batch (a Python loop in the captured step, where the
    reference runs ``lax.fori_loop``) and reports the final next-token
    loss.  Pair with :func:`hpo_space`."""
    model, params0, tokens = _setup(batch_size, seq_len, vocab, d_model, n_heads, n_layers,
                                    seed, device)
    return _device_objective(model, params0, tokens, n_steps)


def hpo_space():
    """lr + weight-decay sweep (the transformer twin of resnet config #4)."""
    from .. import hp

    return {
        "lr": hp.loguniform("lr", np.log(1e-4), np.log(1.0)),
        "wd": hp.loguniform("wd", np.log(1e-6), np.log(1e-2)),
    }


class _BudgetProgram:
    """``n_steps`` of training for one ``(lr, wd)`` and its loss: on the
    card one CUDA graph over static input and output tensors, captured at
    the first call and replayed under the objective's lock; on the CPU
    the same function, run eagerly."""

    def __init__(self, train, device, lock):
        self.train, self.lock = train, lock
        self.graph = None
        if device.type == "cuda":
            self.hypers = torch.zeros(2, dtype=torch.float32, device=device)
            self.loss = torch.zeros((), dtype=torch.float32, device=device)

            def step():
                self.loss.copy_(train(self.hypers[0], self.hypers[1]))

            with lock:
                self.graph = capture_graph(step, device)

    def __call__(self, lr, wd):
        if self.graph is None:
            f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
            return float(self.train(f32(lr), f32(wd)))
        with self.lock:
            self.hypers.copy_(torch.tensor([lr, wd], dtype=torch.float32))
            self.graph.replay()
            return float(self.loss)


def _budget_objective(model, params0, tokens):
    """``fn(cfg, budget) -> float``: one program per distinct budget,
    made at its first use; thread-safe (one lock over the card's graphs,
    made and replayed)."""
    programs = {}
    lock = threading.Lock()
    make = threading.Lock()

    def fn(cfg, budget):
        n = int(budget)
        prog = programs.get(n)
        if prog is None:
            with make:
                prog = programs.get(n)
                if prog is None:
                    prog = programs[n] = _BudgetProgram(
                        _train_from(model, params0, tokens, n), tokens.device, lock)
        return prog(float(cfg["lr"]), float(cfg["wd"]))

    return fn


def budget_objective(batch_size=16, seq_len=16, vocab=16, d_model=16, n_heads=2, n_layers=1,
                     seed=0, device=None):
    """Budget-aware objective of the host schedulers
    (:func:`hyperopt_tpu_torch.hyperband.asha`, ``successive_halving``,
    ``hyperband``): ``fn(cfg, budget) -> float`` trains a TinyLM from one
    initial point for ``budget`` SGD steps on ``device`` (None = the
    card) and reads the final next-token loss.  One program per distinct
    budget -- on the card a captured CUDA graph, made at the budget's
    first call -- and safe to call from the schedulers' worker threads."""
    model, params0, tokens = _setup(batch_size, seq_len, vocab, d_model, n_heads, n_layers,
                                    seed, device)
    return _budget_objective(model, params0, tokens)


def population_objective(n_steps=4, batch_size=16, seq_len=16, vocab=16, d_model=16,
                         n_heads=2, n_layers=1, seed=0, mesh=None, device=None):
    """An ``fmin`` objective: train a TinyLM with the suggested lr/wd for
    ``n_steps`` population steps (a population of one, from
    ``init_population``) on ``device`` (None = the card) and return the
    last step's next-token loss."""
    dev = resolve_device(device)
    model = TinyLM(vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
                   max_len=seq_len)
    step = make_population_train_step(model, mesh=mesh, device=dev)
    init_key, data_key = R.split(R.key(seed, device=dev)).unbind(0)
    tokens = synthetic_token_batch(data_key, batch_size, seq_len, vocab,
                                   n_deltas=min(8, vocab - 1))

    def objective(cfg):
        params = init_population(model, 1, init_key, seq_len, device=dev)
        momentum = zeros_like(params)
        lr = torch.tensor([cfg["lr"]], dtype=torch.float32, device=dev)
        wd = torch.tensor([cfg["wd"]], dtype=torch.float32, device=dev)
        loss = None
        for _ in range(n_steps):
            params, momentum, loss = step(params, momentum, lr, wd, tokens)
        return float(loss[0])

    return objective
