"""Durable checkpoints of the PyTorch port: the chunk-boundary bundles of
the compiled loop, the schedulers' snapshots and population pytrees.

The port's copy of the parts of :mod:`hyperopt_tpu.utils.checkpoint` that
:func:`hyperopt_tpu_torch.device_loop.compile_fmin` and the schedulers
of :mod:`hyperopt_tpu_torch.hyperband` use: the durable writer
(:func:`durable_write`: tmp + fsync + atomic rename) under the pickle
saver and the ``.npz`` one, the guarded loader that turns a truncated
or corrupt file into a
:class:`~hyperopt_tpu_torch.exceptions.CheckpointError`, the chunk
bundle format on top of them, the host schedulers' guarded snapshots
(:func:`save_trials`, :func:`load_guarded`) and the ``.npz`` pytree
pair (:func:`save_pytree`, :func:`load_pytree`) with the reference's
key layout.  Every save, and the chunk and pytree loads, go through the
``fs=`` seam of :mod:`hyperopt_tpu_torch.distributed.faults`, so the
crash tests kill a run inside the torn-publish window.  Bundles hold
host numpy arrays only: a checkpoint never pickles a device tensor.
"""

from __future__ import annotations

import io
import os
import pickle

import numpy as np

from ..distributed.faults import REAL_FS
from ..exceptions import CheckpointError
from . import host_copy

__all__ = [
    "DEVICE_CHUNK_FORMAT",
    "durable_pickle",
    "durable_write",
    "load_device_chunk",
    "load_guarded",
    "load_pickle_guarded",
    "load_pytree",
    "load_trials",
    "read_npz",
    "save_device_chunk",
    "save_pytree",
    "save_trials",
]


def durable_write(data, path, fs=None, crash_between=None):
    """Publish the bytes ``data`` at ``path`` durably: write a tmp file,
    fsync it, then publish it by an atomic rename.  ``crash_between`` names
    a crash point fired between the fsync and the rename (the torn-publish
    window)."""
    fs = REAL_FS if fs is None else fs
    tmp = f"{path}.tmp.{os.getpid()}"
    with fs.open(tmp, "wb") as f:
        f.write(data)
        fs.fsync(f)
        if crash_between:
            fs.crashpoint(crash_between)
    fs.rename(tmp, path)
    return path


def durable_pickle(obj, path, fs=None, crash_between=None):
    """Pickle ``obj`` to ``path`` through :func:`durable_write`."""
    return durable_write(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), path, fs=fs,
                         crash_between=crash_between)


def load_pickle_guarded(path, fs=None, what="checkpoint"):
    """Load a pickle, turning truncation and corruption (``EOFError``,
    ``UnpicklingError``, ...) into a :class:`CheckpointError` that names
    the file."""
    fs = REAL_FS if fs is None else fs
    with fs.open(path, "rb") as f:
        data = f.read()
    try:
        return pickle.loads(data)
    except (EOFError, pickle.UnpicklingError, AttributeError, ImportError,
            IndexError, MemoryError, ValueError) as e:
        raise CheckpointError(
            f"{what} {path!r} is truncated or corrupt ({type(e).__name__}: {e}); "
            "the run must be restarted from scratch"
        ) from e


#: the chunk bundle's format number (the reference's bundles are format 1)
DEVICE_CHUNK_FORMAT = 1


def save_device_chunk(path, bundle, fs=None):
    """Durably publish one chunk-boundary bundle of the compiled loop: the
    carry (``values``/``active``/``losses``/``valid`` as host numpy), the
    seed, the warm offset ``c0`` and ``chunk_next``, the first chunk a
    resumed run replays.  The ``after_ckpt_tmp_before_rename`` crash
    point sits in the torn-publish window."""
    bundle = dict(bundle, format=DEVICE_CHUNK_FORMAT)
    return durable_pickle(bundle, path, fs=fs, crash_between="after_ckpt_tmp_before_rename")


def load_device_chunk(path, guard=None, fs=None):
    """Load a chunk bundle, refusing (:class:`CheckpointError`) a corrupt
    file, another format, and -- when ``guard`` is given -- a bundle
    written by another experiment (space, objective, algo or geometry)."""
    bundle = load_pickle_guarded(path, fs=fs, what="device-loop chunk checkpoint")
    if not isinstance(bundle, dict) or bundle.get("format") != DEVICE_CHUNK_FORMAT:
        fmt = bundle.get("format") if isinstance(bundle, dict) else type(bundle).__name__
        raise CheckpointError(
            f"device-loop chunk checkpoint {path!r} has format {fmt!r}; this loader "
            f"reads format {DEVICE_CHUNK_FORMAT}"
        )
    if guard is not None and bundle.get("guard") is not None \
            and list(bundle["guard"]) != list(guard):
        raise CheckpointError(
            f"device-loop chunk checkpoint {path!r} was written by a different "
            f"experiment (guard {bundle['guard']!r} != {list(guard)!r}); refusing to resume"
        )
    return bundle


def save_trials(obj, path, fs=None):
    """Durably pickle a ``Trials`` store or a host scheduler's snapshot."""
    return durable_pickle(obj, path, fs=fs)


def load_trials(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def load_guarded(path, guard):
    """Load a pickled scheduler snapshot and refuse one whose recorded
    ``guard`` differs: a snapshot from another schedule, space, algo or
    seed is refused (``ValueError``), never reinterpreted."""
    snap = load_trials(path)
    if snap.get("guard") != guard:
        raise ValueError(
            f"checkpoint {path!r} was written by schedule {snap.get('guard')}; refusing to "
            f"resume {guard}"
        )
    return snap


def _leaves_with_keys(tree, prefix=""):
    """``(key, leaf)`` pairs of a pytree of dicts, lists and tuples, each
    key in ``jax.tree_util.keystr``'s form (``['meta']``, ``[0]``), so
    the port's files and the reference's share their layout."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_keys(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_keys(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def save_pytree(tree, path, fs=None):
    """Checkpoint a pytree of arrays or tensors (``compile_pbt``'s or
    ``compile_sha``'s ``out["state"]``, model params) to one ``.npz``,
    keyed by tree path, published through :func:`durable_write` (the
    ``after_ckpt_tmp_before_rename`` crash point sits in its torn-publish
    window).  Pairs with :func:`load_pytree`."""
    buf = io.BytesIO()
    np.savez_compressed(buf, **{k: host_copy(v) for k, v in _leaves_with_keys(tree)})
    return durable_write(buf.getvalue(), path, fs=fs,
                         crash_between="after_ckpt_tmp_before_rename")


def read_npz(path, fs=None):
    """The arrays of an ``.npz`` file, read whole through the ``fs`` seam,
    as ``{key: array}``."""
    fs = REAL_FS if fs is None else fs
    with fs.open(path, "rb") as f:
        data = f.read()
    with np.load(io.BytesIO(data)) as npz:
        return {k: npz[k] for k in npz.files}


def load_pytree(target, path, fs=None):
    """Rebuild a pytree with ``target``'s structure from a saved ``.npz``,
    as host numpy; each leaf's shape and dtype are checked against the
    target's (a live pytree or one of zeros)."""
    data = read_npz(path, fs=fs)
    loaded = []
    for key, leaf in _leaves_with_keys(target):
        if key not in data:
            raise ValueError(f"checkpoint is missing leaf {key!r}")
        arr = data[key]
        want_shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        want_dtype = _dtype_of(leaf)
        if arr.shape != tuple(want_shape) or arr.dtype != want_dtype:
            raise ValueError(
                f"leaf {key!r}: checkpoint {arr.shape}/{arr.dtype} does not match target "
                f"{tuple(want_shape)}/{want_dtype}"
            )
        loaded.append(arr)
    return _rebuild(target, iter(loaded))


def _dtype_of(leaf):
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return np.dtype(type(leaf))
    if hasattr(leaf, "detach"):  # a tensor: its numpy twin
        return np.dtype(str(dt).replace("torch.", ""))
    return np.dtype(dt)


def _rebuild(tree, it):
    """``tree``'s structure filled from ``it``, in
    :func:`_leaves_with_keys`' order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_rebuild(v, it) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return next(it)
