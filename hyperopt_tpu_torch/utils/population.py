"""Population plumbing shared by the training schedulers on the card
(:func:`hyperopt_tpu_torch.pbt.compile_pbt`,
:func:`hyperopt_tpu_torch.hyperband.compile_sha`): log-space hyper
bounds and draws, population pytrees moved and copied in place, and the
refusal of the sharding that is not ported yet (the models'
``mesh=``, ``compile_hyperband(mesh=)``)."""

from __future__ import annotations

import numpy as np
import torch

from .. import random as R
from . import tree_map

__all__ = ["copy_into", "hypers_dict", "log_bounds", "log_uniform_start", "refuse_sharding",
           "to_device"]


def log_bounds(hyper_bounds, device):
    """Validate ``{name: (low, high)}``; (sorted names, log low, log high),
    the bounds as float32 tensors on ``device``."""
    names = sorted(hyper_bounds)
    lo = np.array([float(hyper_bounds[n][0]) for n in names])
    hi = np.array([float(hyper_bounds[n][1]) for n in names])
    if not (lo > 0).all() or not (hi > lo).all():
        raise ValueError("hyper_bounds must satisfy 0 < low < high")
    return (
        names,
        torch.tensor(np.log(lo), dtype=torch.float32, device=device),
        torch.tensor(np.log(hi), dtype=torch.float32, device=device),
    )


def hypers_dict(log_h, names):
    """``{name: [P] tensor}``, the hypers of log-space ``log_h [P, H]``."""
    return {n: torch.exp(log_h[:, i]) for i, n in enumerate(names)}


def log_uniform_start(key, shape, log_lo, log_hi):
    """Log-space hypers drawn uniform in ``[log_lo, log_hi)``: ``log_lo +
    u * (log_hi - log_lo)`` rounded once, as XLA contracts it to an FMA."""
    u = R.uniform(key, shape)
    return R._fma(u, log_hi - log_lo, log_lo)


def refuse_sharding(mesh, what):
    """Refuse ``mesh=`` where the port does not shard yet: the models'
    GSPMD population step and ``compile_hyperband``."""
    if mesh is not None:
        raise NotImplementedError(
            f"{what}(mesh=): sharding the population over a mesh is not ported yet "
            "(ROADMAP.md Queue A, item 15c)"
        )


def to_device(tree, device):
    """A population pytree as tensors on ``device``, in new memory (host
    numpy and tensors alike); float64 leaves become float32, as JAX
    stores them without x64."""

    def leaf(x):
        t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
        if t.dtype == torch.float64:
            t = t.to(torch.float32)
        return t.to(device).clone()

    return tree_map(leaf, tree)


def copy_into(dst, src):
    """Copy the pytree ``src`` into the static tensors of ``dst``, leaf by
    leaf, in place."""
    tree_map(lambda d, s: d.copy_(s), dst, src)
