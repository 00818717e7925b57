"""Durable checkpoints of the PyTorch port: the chunk-boundary bundles of
the compiled loop.

The port's copy of the parts of :mod:`hyperopt_tpu.utils.checkpoint` that
:func:`hyperopt_tpu_torch.device_loop.compile_fmin` uses: the durable
pickle saver (tmp + fsync + atomic rename), the guarded loader that turns
a truncated or corrupt file into a
:class:`~hyperopt_tpu_torch.exceptions.CheckpointError`, and the chunk
bundle format on top of them.  Every file operation goes through the
``fs=`` seam of :mod:`hyperopt_tpu_torch.distributed.faults`, so the
crash tests kill a run inside the torn-publish window.  Bundles hold
host numpy arrays only: a checkpoint never pickles a device tensor.
"""

from __future__ import annotations

import os
import pickle

from ..distributed.faults import REAL_FS
from ..exceptions import CheckpointError

__all__ = [
    "DEVICE_CHUNK_FORMAT",
    "durable_pickle",
    "load_device_chunk",
    "load_pickle_guarded",
    "save_device_chunk",
]


def durable_pickle(obj, path, fs=None, crash_between=None):
    """Pickle ``obj`` to ``path`` durably: write a tmp file, fsync it, then
    publish it by an atomic rename.  ``crash_between`` names a crash point
    fired between the fsync and the rename (the torn-publish window)."""
    fs = REAL_FS if fs is None else fs
    tmp = f"{path}.tmp.{os.getpid()}"
    with fs.open(tmp, "wb") as f:
        f.write(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        fs.fsync(f)
        if crash_between:
            fs.crashpoint(crash_between)
    fs.rename(tmp, path)
    return path


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
