"""Durable checkpoints of the PyTorch port: the chunk-boundary bundles of
the compiled loop, the schedulers' snapshots and population pytrees, the
dense history's ``.npz`` and the sequential driver's crash recovery.

The port's copy of :mod:`hyperopt_tpu.utils.checkpoint`: the durable writer
(:func:`durable_write`: tmp + fsync + atomic rename) under the pickle
saver and the ``.npz`` one, the guarded loader that turns a truncated
or corrupt file into a
:class:`~hyperopt_tpu_torch.exceptions.CheckpointError`, the chunk
bundle format on top of them, the host schedulers' guarded snapshots
(:func:`save_trials`, :func:`load_guarded`) and the ``.npz`` pytree
pair (:func:`save_pytree`, :func:`load_pytree`) with the reference's
key layout, the :class:`~hyperopt_tpu_torch.torch_trials.ObsBuffer`
``.npz`` (:func:`save_obs_buffer`, :func:`obs_buffer_npz_bytes` and their
loaders, the reference's array names), the bit-generator cursor as JSON
(:func:`encode_rstate`, :func:`decode_rstate`), and
:class:`DriverRecovery`, the write-ahead log and bundles behind
``fmin(trials_save_file=, resume_from=)``.  Every save, and the chunk
and pytree loads, go through the ``fs=`` seam of
:mod:`hyperopt_tpu_torch.distributed.faults`, so the crash tests kill a
run inside the torn-publish window.  Bundles hold host numpy arrays
only: a checkpoint never pickles a device tensor.  The Orbax pair of the
reference has no PyTorch twin and raises ``NotImplementedError``.
"""

from __future__ import annotations

import io
import logging
import os
import pickle
import time

import numpy as np

from ..distributed import _common
from ..distributed.faults import REAL_FS
from ..exceptions import CheckpointError
from . import host_copy

logger = logging.getLogger(__name__)

__all__ = [
    "DEVICE_CHUNK_FORMAT",
    "DriverRecovery",
    "RestoredDriverState",
    "decode_rstate",
    "durable_pickle",
    "durable_write",
    "encode_rstate",
    "load_device_chunk",
    "load_guarded",
    "load_obs_buffer",
    "load_obs_buffer_bytes",
    "load_obs_buffer_orbax",
    "load_pickle_guarded",
    "load_pytree",
    "load_trials",
    "obs_buffer_npz_bytes",
    "read_npz",
    "save_device_chunk",
    "save_obs_buffer",
    "save_obs_buffer_orbax",
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


# ---------------------------------------------------------------------------
# the dense history (ObsBuffer) as .npz
# ---------------------------------------------------------------------------


def obs_buffer_npz_bytes(buf):
    """An :class:`~hyperopt_tpu_torch.torch_trials.ObsBuffer`'s host arrays
    and cursors as ``.npz`` bytes, under the reference's names (what
    :class:`DriverRecovery` and the serve snapshots embed).  The arrays
    are the host truth; a device mirror is never saved."""
    bio = io.BytesIO()
    np.savez_compressed(
        bio,
        values=buf.values,
        active=buf.active,
        losses=buf.losses,
        valid=buf.valid,
        tids=buf.tids,
        count=np.int64(buf.count),
        n_scanned=np.int64(buf._n_scanned),
        pending=np.asarray(buf._pending, dtype=np.int64),
        labels=np.asarray(buf.space.labels, dtype=object),
    )
    return bio.getvalue()


def _fill_obs_buffer(space, data):
    """A new ObsBuffer for ``space`` filled from a loaded ``.npz`` mapping
    (copies: nothing aliases the file's arrays); ``ValueError`` when the
    labels are another space's."""
    from ..torch_trials import ObsBuffer

    labels = list(data["labels"])
    if labels != list(space.labels):
        raise ValueError(f"checkpoint labels {labels} do not match space {list(space.labels)}")
    if "tids" not in data:
        raise ValueError("checkpoint has no tids (a format before the reference's round 2)")
    buf = ObsBuffer(space, capacity=int(data["values"].shape[1]))
    buf.values[:] = data["values"]
    buf.active[:] = data["active"]
    buf.losses[:] = data["losses"]
    buf.valid[:] = data["valid"]
    buf.tids[:] = data["tids"]
    buf.count = int(data["count"])
    buf._n_scanned = int(data["n_scanned"])
    buf._pending = [int(i) for i in data["pending"]] if "pending" in data else []
    return buf


def load_obs_buffer_bytes(space, blob):
    """Inverse of :func:`obs_buffer_npz_bytes`."""
    with np.load(io.BytesIO(blob), allow_pickle=True) as data:
        return _fill_obs_buffer(space, data)


def save_obs_buffer(buf, path, fs=None):
    """Durably write an ObsBuffer's ``.npz`` to ``path``."""
    return durable_write(obs_buffer_npz_bytes(buf), path, fs=fs)


def load_obs_buffer(space, path, fs=None):
    """Rebuild an ObsBuffer for ``space`` from a saved ``.npz``."""
    fs = REAL_FS if fs is None else fs
    with fs.open(path, "rb") as f:
        return load_obs_buffer_bytes(space, f.read())


def _no_orbax(name):
    return NotImplementedError(
        f"{name}: Orbax checkpoints are a JAX format with no PyTorch counterpart; use "
        "save_obs_buffer/load_obs_buffer (.npz) instead"
    )


def save_obs_buffer_orbax(buf, directory):
    """Refused: Orbax has no PyTorch twin."""
    raise _no_orbax("save_obs_buffer_orbax")


def load_obs_buffer_orbax(space, directory):
    """Refused: Orbax has no PyTorch twin."""
    raise _no_orbax("load_obs_buffer_orbax")


# ---------------------------------------------------------------------------
# the bit-generator cursor as JSON (for WAL records and bundle metadata)
# ---------------------------------------------------------------------------


def _jsonify_state(v):
    if isinstance(v, np.ndarray):
        return {"__ndarray__": [v.dtype.str, v.tolist()]}
    if isinstance(v, dict):
        return {k: _jsonify_state(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonify_state(x) for x in v]
    if isinstance(v, np.generic):
        return v.item()
    return v


def _dejsonify_state(v):
    if isinstance(v, dict):
        if set(v) == {"__ndarray__"}:
            dtype, data = v["__ndarray__"]
            return np.asarray(data, dtype=np.dtype(dtype))
        return {k: _dejsonify_state(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_dejsonify_state(x) for x in v]
    return v


def encode_rstate(rstate):
    """The bit-generator cursor of an ``np.random.Generator`` (or a legacy
    ``RandomState``) as a JSON-able dict: restoring it and drawing again
    reproduces the exact seed stream."""
    if hasattr(rstate, "bit_generator"):
        return {"kind": "generator", "state": _jsonify_state(rstate.bit_generator.state)}
    return {"kind": "randomstate", "state": _jsonify_state(list(rstate.get_state()))}


def decode_rstate(encoded):
    """Inverse of :func:`encode_rstate`: a new generator at the recorded
    cursor."""
    state = _dejsonify_state(encoded["state"])
    if encoded["kind"] == "generator":
        rstate = np.random.Generator(getattr(np.random, state["bit_generator"])())
        rstate.bit_generator.state = state
        return rstate
    rstate = np.random.RandomState()
    state = list(state)
    state[1] = np.asarray(state[1], dtype=np.uint32)
    rstate.set_state(tuple(state))
    return rstate


# ---------------------------------------------------------------------------
# DriverRecovery: the sequential driver's crash recovery
# ---------------------------------------------------------------------------


class RestoredDriverState:
    """What :meth:`DriverRecovery.load` hands back to ``fmin``."""

    def __init__(self, trials, rstate, ask_ahead_seed, n_replayed_tells, n_replayed_asks):
        self.trials = trials
        self.rstate = rstate
        self.ask_ahead_seed = ask_ahead_seed
        self.n_replayed_tells = n_replayed_tells
        self.n_replayed_asks = n_replayed_asks


class DriverRecovery:
    """Write-ahead log and durable bundles for ``fmin``'s sequential driver.

    Artifacts, all rooted at ``path``:

    * ``path`` -- the pickled ``Trials`` store (durable tmp + fsync +
      rename; loadable by plain ``pickle.load``);
    * ``path.meta`` -- the bundle: guard, bit-generator state, the
      ask-ahead seed, the WAL watermark and each history buffer's
      ``.npz`` bytes (:func:`obs_buffer_npz_bytes`);
    * ``path.wal`` -- the :class:`~hyperopt_tpu_torch.utils.wal.TellWAL`:
      one ``ask`` record per algo call (docs and the rstate cursor after
      its seed draw), one ``tell`` record per applied result, each
      appended before the in-memory mutation.

    Exactly once: a tell in the WAL is never evaluated again (replay
    finalizes its doc before the driver runs) and never applied twice
    (replay skips terminal docs); an ask that never reached the WAL is
    asked again from the restored cursor and draws the same seed.
    ``fs`` is the fault seam the crash tests arm
    :data:`~hyperopt_tpu_torch.distributed.faults.DRIVER_CRASH_POINTS` on;
    ``cadence`` is the number of tells between bundle publishes.
    """

    META_FORMAT = 1

    def __init__(self, path, fs=None, cadence=25, guard=None):
        from .wal import TellWAL

        self.path = str(path)
        self.meta_path = self.path + ".meta"
        self.fs = REAL_FS if fs is None else fs
        self.cadence = max(1, int(cadence))
        self.guard = None if guard is None else list(guard)
        self.wal = TellWAL(self.path + ".wal", fs=self.fs, guard=self.guard)
        self._tells_since_ckpt = 0
        #: wall seconds spent on durability (WAL appends, bundle publishes)
        self.seconds_spent = 0.0

    def set_guard(self, guard):
        """Attach the study fingerprint (``fmin`` builds it): checked
        against every artifact on load and stamped into everything
        written."""
        self.guard = None if guard is None else list(guard)
        self.wal.guard = self.guard

    def exists(self):
        return _common.with_retries(lambda: self.fs.exists(self.path), label="ckpt exists")

    # -- write-ahead records -------------------------------------------------
    def log_ask(self, docs, rstate):
        """Record an algo call's new docs and the rstate cursor after its
        seed draw, before the docs are inserted.  Flush-only: a lost ask
        is drawn again from the restored cursor, and the next tell's
        fsync covers it."""
        t0 = time.perf_counter()
        self.fs.crashpoint("before_wal_append")
        self.wal.append("ask", {"docs": docs, "rstate": encode_rstate(rstate)}, sync=False)
        self.fs.crashpoint("after_wal_append_before_tell")
        self.seconds_spent += time.perf_counter() - t0

    def log_tell(self, tid, state, result=None, error=None, tb=None):
        """Durably record one finished (or errored) evaluation before its
        result is applied to the store."""
        t0 = time.perf_counter()
        self.fs.crashpoint("before_wal_append")
        rec = {"tid": int(tid), "state": int(state)}
        if result is not None:
            rec["result"] = result
        if error is not None:
            rec["error"] = error
        if tb is not None:
            rec["traceback"] = tb
        self.wal.append("tell", rec)
        self.fs.crashpoint("after_wal_append_before_tell")
        self.seconds_spent += time.perf_counter() - t0
        self._tells_since_ckpt += 1

    # -- bundles -------------------------------------------------------------
    def maybe_checkpoint(self, trials, rstate, ask_ahead_seed=None, force=False):
        """Publish a bundle when the cadence (or ``force``) says so."""
        if not force and self._tells_since_ckpt < self.cadence:
            return False
        self.checkpoint(trials, rstate, ask_ahead_seed=ask_ahead_seed)
        return True

    def checkpoint(self, trials, rstate, ask_ahead_seed=None):
        """Publish the driver state: the trials pickle, then the bundle,
        then compact the WAL.  A crash in any window between them leaves a
        stale artifact that the WAL records outliving it supersede, and
        replay deduplicates by tid."""
        t0 = time.perf_counter()
        obs_npz = [obs_buffer_npz_bytes(buf)
                   for buf in getattr(trials, "_buffers", {}).values()]
        meta = {
            "format": self.META_FORMAT,
            "guard": self.guard,
            "n_trials": len(trials._dynamic_trials),
            "wal_seq": self.wal.next_seq,
            "total_tells": self.wal.total_tells,
            "rstate": encode_rstate(rstate),
            "ask_ahead_seed": None if ask_ahead_seed is None else int(ask_ahead_seed),
            "obs_npz": obs_npz,
        }
        # each publish retries whole on a transient fault; a crash point
        # firing inside is a BaseException and propagates
        _common.with_retries(
            lambda: durable_pickle(trials, self.path, fs=self.fs,
                                   crash_between="after_ckpt_tmp_before_rename"),
            label="trials publish")
        _common.with_retries(
            lambda: durable_pickle(meta, self.meta_path, fs=self.fs,
                                   crash_between="after_ckpt_tmp_before_rename"),
            label="bundle publish")
        self.fs.crashpoint("after_ckpt_publish_before_wal_reset")
        _common.with_retries(self.wal.reset, label="wal reset")
        self._tells_since_ckpt = 0
        self.seconds_spent += time.perf_counter() - t0
        return self.path

    # -- restore -------------------------------------------------------------
    def load(self):
        """The durable driver state with the WAL replayed, or None when no
        trials artifact exists.  Refuses (:class:`CheckpointError`) another
        study's artifacts and mid-file WAL corruption; a torn WAL tail is
        truncated."""
        if not self.exists():
            return None
        trials = load_pickle_guarded(self.path, fs=self.fs, what="trials checkpoint")
        meta = None
        if self.fs.exists(self.meta_path):
            meta = load_pickle_guarded(self.meta_path, fs=self.fs, what="checkpoint bundle")
            if (self.guard is not None and meta.get("guard") is not None
                    and list(meta["guard"]) != list(self.guard)):
                raise CheckpointError(
                    f"checkpoint bundle {self.meta_path!r} was written by a different study "
                    f"(guard {meta['guard']!r} != {self.guard!r}); refusing to resume"
                )
        records = self.wal.replay() if self.wal.exists() else []
        watermark = meta["wal_seq"] if meta else 0
        suffix = [r for r in records if int(r["seq"]) >= watermark]
        n_asks, n_tells, last_cursor = self._apply_records(trials, suffix)
        if last_cursor is not None:
            rstate, seed = decode_rstate(last_cursor), None
        elif meta is not None:
            rstate = decode_rstate(meta["rstate"])
            seed = meta.get("ask_ahead_seed")
        else:
            rstate, seed = None, None
            logger.warning(
                "resuming %r without recovery metadata: trials are restored but the "
                "suggestion stream will not match the uninterrupted run", self.path)
        if meta is not None and meta.get("obs_npz"):
            # TorchTrials rebuilds its history buffers from these instead
            # of scanning the whole doc list again
            trials._stashed_obs_npz = list(meta["obs_npz"])
        return RestoredDriverState(trials, rstate, seed, n_tells, n_asks)

    @staticmethod
    def _apply_records(trials, records):
        """Replay a WAL suffix into ``trials`` exactly once: asks insert
        the docs not present yet (in record order, which is tid order),
        tells finalize the docs that are not terminal yet."""
        from ..base import JOB_STATE_DONE, JOB_STATE_ERROR, validate_trial

        by_tid = {t["tid"]: t for t in trials._dynamic_trials}
        n_asks = n_tells = 0
        last_cursor = None
        for rec in records:
            if rec.get("kind") == "ask":
                last_cursor = rec["rstate"]
                fresh = [validate_trial(d) for d in rec["docs"] if d["tid"] not in by_tid]
                if fresh:
                    trials._insert_trial_docs(fresh)
                    for doc in fresh:
                        by_tid[doc["tid"]] = doc
                    n_asks += 1
            elif rec.get("kind") == "tell":
                doc = by_tid.get(rec["tid"])
                if doc is not None and doc["state"] not in (JOB_STATE_DONE, JOB_STATE_ERROR):
                    doc["state"] = rec["state"]
                    if "result" in rec:
                        doc["result"] = rec["result"]
                    if "error" in rec:
                        doc["misc"]["error"] = rec["error"]
                    if "traceback" in rec:
                        doc["misc"]["traceback"] = rec["traceback"]
                    n_tells += 1
        trials.refresh()
        return n_asks, n_tells, last_cursor
