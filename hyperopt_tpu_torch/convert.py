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
           "pbt_result_from_numpy", "population_state_from_numpy", "resnet_params_from_numpy",
           "sha_result_from_numpy", "space_consts_from_numpy", "study_batch_from_numpy",
           "tinylm_params_from_numpy", "trainable_state_from_numpy"]


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


# flax layouts -> torch layouts, on the trailing axes (a leading population
# axis passes through)
def _dense(p):
    """``Dense``: kernel ``[in, out]`` -> weight ``[out, in]``; bias as is."""
    return {"weight": np.swapaxes(p["kernel"], -1, -2), "bias": p["bias"]}


def _norm(p):
    """``LayerNorm``/``GroupNorm``: scale, bias -> weight, bias."""
    return {"weight": p["scale"], "bias": p["bias"]}


def _conv(p):
    """``Conv``: kernel HWIO -> weight OIHW."""
    return {"weight": np.moveaxis(p["kernel"], (-4, -3, -2, -1), (-2, -1, -3, -4))}


def _heads_in(p):
    """``DenseGeneral`` to heads: kernel ``[d, h, hd]`` -> ``[h*hd, d]``,
    bias ``[h, hd]`` -> ``[h*hd]``."""
    k, b = p["kernel"], p["bias"]
    return {"weight": np.swapaxes(k.reshape(k.shape[:-2] + (-1,)), -1, -2),
            "bias": b.reshape(b.shape[:-2] + (-1,))}


def _heads_out(p):
    """``DenseGeneral`` from heads: kernel ``[h, hd, d]`` -> ``[d, h*hd]``."""
    k = p["kernel"]
    return {"weight": np.swapaxes(k.reshape(k.shape[:-3] + (-1, k.shape[-1])), -1, -2),
            "bias": p["bias"]}


def _flat(named, device):
    dev = resolve_device(device)
    return {f"{prefix}.{leaf}": torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for prefix, leaves in named for leaf, v in leaves.items()}


def _numbered(tree, name):
    """``tree[f"{name}_0"]``, ``tree[f"{name}_1"]``, ... while present."""
    out = []
    while f"{name}_{len(out)}" in tree:
        out.append(tree[f"{name}_{len(out)}"])
    return out


def tinylm_params_from_numpy(params, device=None):
    """The reference's flax ``TinyLM`` parameters (a nested dict of numpy
    arrays, with or without the leading population axis) -> the port's
    :class:`~hyperopt_tpu_torch.models.transformer.TinyLM` parameters,
    ``{name: tensor}`` on ``device``, so that ``functional_call(TinyLM(...),
    converted, tokens)`` is ``model.apply({"params": params}, tokens)``."""
    named = [("tok_emb", {"weight": params["Embed_0"]["embedding"]}),
             ("pos_emb", {"weight": params["Embed_1"]["embedding"]})]
    for i, blk in enumerate(_numbered(params, "Block")):
        att = blk["SelfAttention_0"]
        named += [(f"blocks.{i}.ln1", _norm(blk["LayerNorm_0"])),
                  (f"blocks.{i}.query", _heads_in(att["query"])),
                  (f"blocks.{i}.key", _heads_in(att["key"])),
                  (f"blocks.{i}.value", _heads_in(att["value"])),
                  (f"blocks.{i}.out", _heads_out(att["out"])),
                  (f"blocks.{i}.ln2", _norm(blk["LayerNorm_1"])),
                  (f"blocks.{i}.fc1", _dense(blk["Dense_0"])),
                  (f"blocks.{i}.fc2", _dense(blk["Dense_1"]))]
    named += [("ln_f", _norm(params["LayerNorm_0"])), ("head", _dense(params["Dense_0"]))]
    return _flat(named, device)


def resnet_params_from_numpy(params, device=None):
    """The reference's flax ``ResNet`` parameters (a nested dict of numpy
    arrays, with or without the leading population axis) -> the port's
    :class:`~hyperopt_tpu_torch.models.resnet.ResNet` parameters on
    ``device``: convolutions HWIO -> OIHW, GroupNorm ``scale`` ->
    ``weight``."""
    named = [("stem", _conv(params["Conv_0"])), ("stem_norm", _norm(params["GroupNorm_0"]))]
    for i, blk in enumerate(_numbered(params, "BasicBlock")):
        named += [(f"blocks.{i}.conv1", _conv(blk["Conv_0"])),
                  (f"blocks.{i}.norm1", _norm(blk["GroupNorm_0"])),
                  (f"blocks.{i}.conv2", _conv(blk["Conv_1"])),
                  (f"blocks.{i}.norm2", _norm(blk["GroupNorm_1"]))]
        if "Conv_2" in blk:
            named += [(f"blocks.{i}.shortcut", _conv(blk["Conv_2"])),
                      (f"blocks.{i}.shortcut_norm", _norm(blk["GroupNorm_2"]))]
    named.append(("head", _dense(params["Dense_0"])))
    return _flat(named, device)
