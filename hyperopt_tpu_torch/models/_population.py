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

A step on a mesh (:func:`on_mesh`) is the reference's GSPMD placement
read for the port: the population on the ``trial`` axis and the data
batch on ``data_axis``, checked as the reference's sharding constraints
check them, and the unsharded step computed, so it is bitwise the step
without a mesh.
"""

from __future__ import annotations

import contextlib
import math
import threading

import numpy as np
import torch
from torch import nn

from .. import random as R
from ..utils import resolve_device

__all__ = ["apply", "deterministic_kernels", "init_members", "member_train_step", "on_mesh",
           "sgd_update", "zeros_like"]

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


def member_train_step(loss_fn, params, momentum, lr, wd, *data):
    """One member's gradient step: ``(params, momentum, loss)``, the loss
    taken before the update."""
    grads, loss = torch.func.grad_and_value(loss_fn)(params, *data)
    params, momentum = sgd_update(params, momentum, grads, lr, wd)
    return params, momentum, loss


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


def on_mesh(step, mesh, trial_axis, data_axis, what):
    """``step(pop_params, pop_momentum, lr, wd, *data)`` placed on
    ``mesh`` as the reference constrains it: the population along
    ``trial_axis``, each data tensor's leading (batch) axis along
    ``data_axis`` (None replicates it).  GSPMD computes the unsharded
    math, and so does the port: the axes must exist and the widths
    divide, and then the unsharded step runs.  On a mesh of real ranks
    (:func:`~hyperopt_tpu_torch.parallel.mesh.over_processes`) each rank
    passes its own block of members; a ``data_axis`` over processes would
    need a gradient all-reduce inside the captured step, which ``gloo``
    cannot join, and is refused.  None returns ``step``."""
    if mesh is None:
        return step
    from ..parallel.mesh import RankMesh, over_processes

    if not isinstance(mesh, RankMesh):
        raise TypeError(
            f"{what}: mesh= takes a parallel.mesh.RankMesh (virtual_mesh, mesh_from_spec); got "
            f"{type(mesh).__name__}")
    for name, axis in (("trial_axis", trial_axis), ("data_axis", data_axis)):
        if axis is not None and axis not in mesh.shape:
            raise ValueError(
                f"{what}: {name} {axis!r} is not an axis of the mesh (axes: {tuple(mesh.shape)})")
    n_trial = int(mesh.shape[trial_axis]) if trial_axis is not None else 1
    n_data = int(mesh.shape[data_axis]) if data_axis is not None else 1
    if over_processes(mesh):
        if n_data > 1:
            raise NotImplementedError(
                f"{what}: the data axis {data_axis!r} over {n_data} processes needs a gradient "
                "all-reduce inside the captured step, which gloo cannot join (ROADMAP.md Queue "
                "A, item 15c, part 6: nccl, a card per rank)")
        n_trial = 1  # each rank passes its own block of members

    def placed(pop_params, pop_momentum, lr, wd, *data):
        for label, x, n, axis in [("population", next(iter(pop_params.values())), n_trial,
                                   trial_axis)] + [("data batch", d, n_data, data_axis)
                                                   for d in data]:
            if x.shape[0] % n:
                raise ValueError(
                    f"{what}: the {label}'s dimension 0 ({x.shape[0]}) must divide by the "
                    f"{axis!r} mesh axis size {n} (full shape: {tuple(x.shape)})")
        return step(pop_params, pop_momentum, lr, wd, *data)

    return placed
