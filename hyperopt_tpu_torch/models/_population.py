"""Population training pieces shared by the port's model families
(:mod:`~hyperopt_tpu_torch.models.transformer`,
:mod:`~hyperopt_tpu_torch.models.resnet`).

A population is a dict ``{parameter name: [P, ...] tensor}`` of one
``nn.Module``'s parameters with the members on the leading axis; a step
maps one member's ``torch.func.grad_and_value`` of
``torch.func.functional_call`` over the members with
``torch.func.vmap``.  The optimizer is the reference's SGD with momentum
0.9 and coupled weight decay.

Initialization draws every member from ``random.split(key, P)`` on the
port's threefry, each leaf from flax's default family and scale for its
layer (lecun normal, a truncated normal, for dense and convolution
kernels; ``variance_scaling(1.0, "fan_in", "normal", out_axis=0)`` for
embeddings; zeros for biases; ones and zeros for the norms).  Its bits
are not flax's, which folds module paths into its keys: only the
distribution is the reference's.

A step (:class:`PopulationStep`) has two halves: the gradient half,
``grad_and_value`` of each member's loss on the given rows, and the
update half, :func:`sgd_update`.  A step on a mesh (:func:`on_mesh`) is
the reference's GSPMD placement read for the port: the population on the
``trial`` axis and the data batch on ``data_axis``, checked as the
reference's sharding constraints check them.  Inside one process (a
``virtual_mesh``, or one rank) the unsharded step runs, bitwise the step
without a mesh.  Over real ranks each rank passes its own block of
members, and a ``data_axis`` over processes cuts the step where GSPMD
puts its gradient all-reduce: each rank of the data line runs the
gradient half on its rows of the batch, one host gather
(:func:`~hyperopt_tpu_torch.parallel.multihost.fetch_global`) brings every
rank's gradients and losses, and every rank combines them in rank order
(:func:`combine_slices`: the mean of the slices' means, the full batch's
mean since the slices are equal) before the update half.  The ranks of a
line then hold the same bits, those of :func:`split_twin`, which runs
the slices in turn in one process.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading

import numpy as np
import torch
from torch import nn

from .. import random as R
from ..utils import resolve_device

__all__ = ["PopulationStep", "apply", "combine_slices", "deterministic_kernels", "init_members",
           "member_grads", "on_mesh", "sgd_update", "split_twin", "zeros_like"]

# lecun_normal: a normal truncated to [-2, 2] scaled by this back to unit variance
_TRUNC_STD = 0.87962566103423978
_ERF_LO = float(np.float32(math.erf(-math.sqrt(2.0))))
_ERF_HI = float(np.float32(math.erf(math.sqrt(2.0))))
_TRUNC_LO = float(np.nextafter(np.float32(-2.0), np.float32(0.0)))
_TRUNC_HI = float(np.nextafter(np.float32(2.0), np.float32(0.0)))


def _truncated_normal(keys, shape):
    """Standard normals truncated to (-2, 2) by ``jax.random.
    truncated_normal``'s algorithm: erfinv of uniforms between the
    bounds' erf."""
    u = R.uniform(keys, shape, _ERF_LO, _ERF_HI)
    return (R._erfinv(u) * R._SQRT2).clamp(_TRUNC_LO, _TRUNC_HI)


def _leaf_kinds(model):
    """``{parameter name: (kind, fan_in)}`` in ``named_parameters`` order:
    the flax default initializer of the layer that owns each leaf."""
    kinds = {}
    for prefix, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f"{prefix}.{name}" if prefix else name
            if isinstance(mod, (nn.Linear, nn.Conv2d)) and name == "weight":
                kinds[full] = ("lecun", math.prod(p.shape[1:]))
            elif isinstance(mod, nn.Embedding):
                kinds[full] = ("embed", p.shape[1])
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)) and name == "weight":
                kinds[full] = ("ones", None)
            elif name == "bias":
                kinds[full] = ("zeros", None)
            else:
                raise TypeError(f"no flax initializer for {type(mod).__name__}.{name}")
    return {n: kinds[n] for n, _ in model.named_parameters()}


def init_members(model, pop_size, key, device=None):
    """A population of ``pop_size`` members of ``model``'s parameters on
    ``device`` (None = the card): member ``i`` from ``split(key, P)[i]``,
    leaf ``j`` of it from that key's ``split(., n_leaves)[j]``."""
    dev = resolve_device(device)
    P = int(pop_size)
    kinds = _leaf_kinds(model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    member_keys = R.split(key.to(dev), P)
    leaf_keys = R.split(member_keys, len(kinds))  # [P, n_leaves, 2]
    out = {}
    for j, (name, (kind, fan_in)) in enumerate(kinds.items()):
        shape = shapes[name]
        k = leaf_keys[:, j]
        if kind == "lecun":
            out[name] = _truncated_normal(k, shape) * float(
                np.float32(math.sqrt(1.0 / fan_in) / _TRUNC_STD))
        elif kind == "embed":
            out[name] = R.normal(k, shape) * float(np.float32(math.sqrt(1.0 / fan_in)))
        else:
            fill = 1.0 if kind == "ones" else 0.0
            out[name] = torch.full((P,) + shape, fill, dtype=torch.float32, device=dev)
    return out


# functional_call swaps the given tensors into the module for the call's
# length: two threads calling one module must take turns
_APPLY_LOCK = threading.Lock()


def apply(model, params, *args):
    """``model(*args)`` at ``params`` (``torch.func.functional_call``),
    one thread at a time per process; the backward pass needs no lock."""
    with _APPLY_LOCK:
        return torch.func.functional_call(model, params, args)


def zeros_like(params):
    """Zero momentum for a population (or one member)."""
    return {k: torch.zeros_like(v) for k, v in params.items()}


def sgd_update(params, momentum, grads, lr, wd):
    """The reference's member update: SGD with momentum 0.9 and coupled
    weight decay, ``m' = 0.9 m + g``, ``p' = p - lr (m' + wd p)``."""
    new_momentum = {k: 0.9 * momentum[k] + grads[k] for k in params}
    new_params = {k: params[k] - lr * (new_momentum[k] + wd * params[k]) for k in params}
    return new_params, new_momentum


def member_grads(loss_fn, params, *data):
    """One member's gradient half: ``(grads, loss)`` of ``loss_fn`` at
    ``params`` on the given rows."""
    return torch.func.grad_and_value(loss_fn)(params, *data)


@contextlib.contextmanager
def deterministic_kernels():
    """cuDNN's deterministic algorithms, chosen without benchmarking,
    for the block only: a convolution's weight gradient then has the
    same bits in every run, eager or captured.  The process's own
    settings come back on exit."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


class PopulationStep:
    """``step(pop_params, pop_momentum, lr [P], wd [P], *data) -> (params,
    momentum, losses [P])``: every member's gradient half
    (:meth:`grad_half`, the data tensors shared) and then its update half
    (:meth:`update_half`), each under ``context()`` (ResNet's
    :func:`deterministic_kernels`); the losses are taken before the
    update."""

    def __init__(self, loss_fn, context=contextlib.nullcontext):
        self._member_grads = functools.partial(member_grads, loss_fn)
        self._update = torch.func.vmap(sgd_update)
        self.context = context

    def __call__(self, pop_params, pop_momentum, lr, wd, *data):
        grads, losses = self.grad_half(pop_params, *data)
        params, momentum = self.update_half(pop_params, pop_momentum, grads, lr, wd)
        return params, momentum, losses

    def grad_half(self, pop_params, *data):
        """``(grads {name: [P, ...]}, losses [P])`` of every member on the
        given rows."""
        grads = torch.func.vmap(self._member_grads, in_dims=(0,) + (None,) * len(data))
        with self.context():
            return grads(pop_params, *data)

    def update_half(self, pop_params, pop_momentum, grads, lr, wd):
        """``(params, momentum)`` after every member's :func:`sgd_update`."""
        with self.context():
            return self._update(pop_params, pop_momentum, grads, lr, wd)


def combine_slices(stacked):
    """The mean of the ``n`` slice means stacked on the leading axis, in
    rank order: ``(((s_0 + s_1) + s_2) ...) / n``."""
    acc = stacked[0]
    for k in range(1, stacked.shape[0]):
        acc = acc + stacked[k]
    return acc / stacked.shape[0]


def _rows(data, n, index):
    """Slice ``index`` of ``n`` equal slices of each data tensor's rows."""
    rows = data[0].shape[0] // n
    return [d[index * rows:(index + 1) * rows] for d in data]


def _combined_update(step, pop_params, pop_momentum, lr, wd, slices):
    """The update half on the combined gradients of ``slices`` (``{"grads":
    {name: [n, P, ...]}, "losses": [n, P]}``): ``(params, momentum,
    losses [P])``."""
    grads = {k: combine_slices(v) for k, v in slices["grads"].items()}
    params, momentum = step.update_half(pop_params, pop_momentum, grads, lr, wd)
    return params, momentum, combine_slices(slices["losses"])


def split_twin(step, n):
    """The in-process twin of ``step`` (a :class:`PopulationStep`) with its
    data batch split over ``n`` ranks: the gradient half on each slice of
    the rows in turn, then the combine and the update half every rank of
    the line runs.  Bitwise each rank's step; the checks' reference."""

    def twin(pop_params, pop_momentum, lr, wd, *data):
        halves = [step.grad_half(pop_params, *_rows(data, n, i)) for i in range(int(n))]
        slices = {"grads": {k: torch.stack([g[k] for g, _ in halves]) for k in halves[0][0]},
                  "losses": torch.stack([loss for _, loss in halves])}
        return _combined_update(step, pop_params, pop_momentum, lr, wd, slices)

    return twin


def _over_line(step, n, index, group):
    """``step`` with its data split over the ``n`` ranks of ``group``: this
    rank's gradient half on slice ``index``, ONE gather of every rank's
    gradients and losses (each stacked on a new leading axis), then the
    combine and the update half.  A failed gather raises."""
    from ..parallel import multihost

    def split(pop_params, pop_momentum, lr, wd, *data):
        grads, losses = step.grad_half(pop_params, *_rows(data, n, index))
        got = multihost.fetch_global({"grads": {k: v[None] for k, v in grads.items()},
                                      "losses": losses[None]}, sharded=True, group=group)
        dev = losses.device
        slices = {"grads": {k: torch.from_numpy(v).to(dev) for k, v in got["grads"].items()},
                  "losses": torch.from_numpy(got["losses"]).to(dev)}
        return _combined_update(step, pop_params, pop_momentum, lr, wd, slices)

    return split


def on_mesh(step, mesh, trial_axis, data_axis, what):
    """``step(pop_params, pop_momentum, lr, wd, *data)`` placed on
    ``mesh`` as the reference constrains it: the population along
    ``trial_axis``, each data tensor's leading (batch) axis along
    ``data_axis`` (None replicates it).  The axes must exist and the
    widths divide.  Inside one process GSPMD's unsharded math runs, the
    step itself.  On a mesh of real ranks
    (:func:`~hyperopt_tpu_torch.parallel.mesh.over_processes`) each rank
    passes its own block of members; a ``data_axis`` over processes splits
    the batch over the rank's line on it
    (:func:`~hyperopt_tpu_torch.parallel.mesh.process_line`), the step a
    :class:`PopulationStep`: the rank's gradient half, one gather, the
    combine and the update half (bitwise :func:`split_twin`).  None
    returns ``step``."""
    if mesh is None:
        return step
    from ..parallel import mesh as M

    if not isinstance(mesh, M.RankMesh):
        raise TypeError(
            f"{what}: mesh= takes a parallel.mesh.RankMesh (virtual_mesh, mesh_from_spec); got "
            f"{type(mesh).__name__}")
    for name, axis in (("trial_axis", trial_axis), ("data_axis", data_axis)):
        if axis is not None and axis not in mesh.shape:
            raise ValueError(
                f"{what}: {name} {axis!r} is not an axis of the mesh (axes: {tuple(mesh.shape)})")
    n_trial = int(mesh.shape[trial_axis]) if trial_axis is not None else 1
    n_data = int(mesh.shape[data_axis]) if data_axis is not None else 1
    run = step
    if M.over_processes(mesh):
        n_trial = 1  # each rank passes its own block of members
        if n_data > 1:
            run = _over_line(step, *M.process_line(mesh, data_axis, what))

    def placed(pop_params, pop_momentum, lr, wd, *data):
        for label, x, n, axis in [("population", next(iter(pop_params.values())), n_trial,
                                   trial_axis)] + [("data batch", d, n_data, data_axis)
                                                   for d in data]:
            if x.shape[0] % n:
                raise ValueError(
                    f"{what}: the {label}'s dimension 0 ({x.shape[0]}) must divide by the "
                    f"{axis!r} mesh axis size {n} (full shape: {tuple(x.shape)})")
        return run(pop_params, pop_momentum, lr, wd, *data)

    return placed
