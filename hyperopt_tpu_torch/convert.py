"""Carry state across from the JAX reference into the port.

Plain numpy in, tensors out: the tests use these to make both packages
compute on the same history, keys and space constants.  Nothing here
imports the reference; callers hand over its numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.compile import CONST_FIELDS
from .ops.kernels import HistoryState
from .utils import resolve_device

__all__ = ["device_loop_result_from_numpy", "history_from_numpy", "key_from_numpy",
           "pbt_result_from_numpy", "population_state_from_numpy", "sha_result_from_numpy",
           "space_consts_from_numpy", "study_batch_from_numpy", "trainable_state_from_numpy"]


def history_from_numpy(values, active, losses, valid, device=None):
    """A reference ``ObsBuffer``'s four arrays -> the port's
    :class:`~hyperopt_tpu_torch.ops.kernels.HistoryState` on ``device``."""
    dev = resolve_device(device)
    arrays = (
        np.array(values, dtype=np.float32),
        np.array(active, dtype=bool),
        np.array(losses, dtype=np.float32),
        np.array(valid, dtype=bool),
    )  # copies: jax hands out read-only views
    return HistoryState(*(torch.from_numpy(a).to(dev) for a in arrays))


def key_from_numpy(key_data, device=None):
    """``jax.random.key_data(key)`` (uint32 ``[..., 2]``) -> a port key
    (int64 ``[..., 2]``)."""
    data = np.asarray(key_data, dtype=np.uint32).astype(np.int64)  # a copy
    return torch.from_numpy(data).to(resolve_device(device))


def space_consts_from_numpy(ps, device=None):
    """A reference ``PackedSpace``'s numpy fields -> the port's
    :attr:`~hyperopt_tpu_torch.ops.compile.PackedSpace.consts` layout."""
    dev = resolve_device(device)
    out = {}
    for k in CONST_FIELDS:
        a = np.array(getattr(ps, k))
        if a.dtype == np.int32:
            a = a.astype(np.int64)
        out[k] = torch.from_numpy(a).to(dev)
    return out


def study_batch_from_numpy(values, active, losses, valid, device=None):
    """The reference's stacked serve state (its ``StudyBatchState``'s
    four arrays, ``[S, D, cap]`` / ``[S, cap]``) -> the port's
    :class:`~hyperopt_tpu_torch.serve.batched.StudyBatchState` on
    ``device``, in new tensors."""
    from .serve.batched import StudyBatchState

    return StudyBatchState(*history_from_numpy(values, active, losses, valid, device))


def trainable_state_from_numpy(state, device=None):
    """A reference ``TrainableObjective`` state -- a pytree (dicts, tuples,
    lists) of numpy arrays, such as ``(params, momentum)`` -- as the same
    pytree of float32 tensors on ``device``, in new memory."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    return conv(state)


def device_loop_result_from_numpy(out):
    """A reference ``compile_fmin`` result dict -> the ``values``/``active``/
    ``losses`` host arrays the port's runner takes as ``init=`` (copies,
    in the port's dtypes)."""
    return {
        "values": np.array(out["values"], dtype=np.float32),
        "active": np.array(out["active"], dtype=bool),
        "losses": np.array(out["losses"], dtype=np.float32),
    }


def population_state_from_numpy(state, device=None):
    """A reference scheduler population -- a pytree (dicts, tuples, lists)
    of numpy arrays with the members on the leading axis, as
    ``compile_pbt``/``compile_sha`` take and return it -- as the same
    pytree of tensors on ``device``, in new memory and in each leaf's own
    dtype."""
    from .utils import tree_map

    dev = resolve_device(device)
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(dev), state)


def pbt_result_from_numpy(out, device=None):
    """A reference ``compile_pbt`` result -> the port's form: ``state`` as
    tensors on ``device``, ``hypers`` and ``loss_history`` as float32
    numpy copies; ``runner(init=...)`` of the port takes it."""
    return {
        **{k: v for k, v in out.items() if k not in ("state", "hypers", "loss_history")},
        "state": population_state_from_numpy(out["state"], device),
        "hypers": {n: np.array(v, dtype=np.float32) for n, v in out["hypers"].items()},
        "loss_history": np.array(out["loss_history"], dtype=np.float32),
    }


def sha_result_from_numpy(out, device=None):
    """A reference ``compile_sha`` result -> the port's form: the surviving
    ``state`` as tensors on ``device``, the bookkeeping as is."""
    return {**out, "state": population_state_from_numpy(out["state"], device)}
