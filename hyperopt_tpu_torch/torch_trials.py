"""Dense observation history of the PyTorch port.

The counterpart of :mod:`hyperopt_tpu.jax_trials`: :class:`ObsBuffer`
incrementally mirrors a ``Trials`` store (only completed, status-ok,
finite-loss trials enter the posterior) into preallocated dense numpy
buffers -- values + active masks per hyperparameter, losses + validity --
grown 4x at a time, and hands the suggest path a device copy sliced to a
power-of-two bucket of the live count.  Two device views:

* re-upload (default): the device copy is rebuilt when the history
  changed and cached while it did not;
* resident (``resident=True``, :class:`TorchTrials`): the buffer owns a
  device mirror that each in-order tell updates in place with an O(D)
  delta (:func:`hyperopt_tpu_torch.ops.kernels.apply_delta`); bucket
  growth, late inserts and long backlogs re-materialize it.

Either view is a copy: no device tensor shares memory with the host
arrays, also on ``device="cpu"``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .base import Trials, posterior_state
from .ops.compile import compile_space
from .ops.kernels import HistoryState, apply_delta

__all__ = [
    "GROWTH_FACTOR",
    "MAX_PENDING_DELTAS",
    "MIN_CAPACITY",
    "ObsBuffer",
    "TorchTrials",
    "cached_suggest_fn",
    "obs_buffer_for",
    "packed_space_for",
]

MIN_CAPACITY = 128
GROWTH_FACTOR = 4

# Resident mode: past this many staged-but-unapplied delta tells, one full
# re-materialization is cheaper than a chain of deltas -- reached only when
# many tells land between asks (startup, batched completions).
MAX_PENDING_DELTAS = 32


def _upload(arrays, device):
    """Host arrays -> a :class:`HistoryState` of COPIES on ``device``
    (``torch.from_numpy(a).to("cpu")`` would alias ``a``)."""
    return HistoryState(*(torch.tensor(a, device=device) for a in arrays))


class ObsBuffer:
    """Dense, capacity-bucketed mirror of completed trials for one space.

    Arrays (host numpy, the source of truth):
      values: [D, cap] natural-space draws (garbage where inactive)
      active: [D, cap] per-dim activity mask
      losses: [cap]
      valid:  [cap] slot occupancy
    Slots are tid-ordered (time order for forgetting weights).  The
    deterministic counters ``transfer_bytes_total`` / ``delta_tells`` /
    ``full_uploads`` / ``dispatch_count`` (plain ints) expose the
    host->device traffic and the suggest programs run against this
    buffer, counted as the reference counts them: a full upload moves
    ``bucket * (5 * D + 5)`` bytes, a delta ``5 * D + 8``.
    """

    def __init__(self, space, capacity=MIN_CAPACITY, resident=False):
        self.space = space
        self.capacity = int(capacity)
        D = space.n_dims
        self.values = np.zeros((D, self.capacity), dtype=np.float32)
        self.active = np.zeros((D, self.capacity), dtype=bool)
        self.losses = np.zeros(self.capacity, dtype=np.float32)
        self.valid = np.zeros(self.capacity, dtype=bool)
        self.tids = np.zeros(self.capacity, dtype=np.int64)
        self.count = 0
        self._n_scanned = 0  # trials-list prefix already scanned
        self._pending = []  # scanned-but-still-pending doc indices
        self._generation = 0  # bumped on every mutation
        self._device_cache = None  # ((generation, bucket), HistoryState)
        self._label_pos = {label: d for d, label in enumerate(space.labels)}
        self.resident = bool(resident)
        self._resident = None  # {"bucket": int, "arrays": HistoryState}
        self._resident_full = True  # mirror needs a full materialization
        self._pending_deltas = []  # [(slot, values-col, active-col, loss)]
        self.transfer_bytes_total = 0
        self.delta_tells = 0
        self.full_uploads = 0
        self.dispatch_count = 0

    def _grow(self):
        new_cap = self.capacity * GROWTH_FACTOR
        for name in ("values", "active"):
            old = getattr(self, name)
            new = np.zeros((old.shape[0], new_cap), dtype=old.dtype)
            new[:, : self.capacity] = old
            setattr(self, name, new)
        for name in ("losses", "valid", "tids"):
            old = getattr(self, name)
            new = np.zeros(new_cap, dtype=old.dtype)
            new[: self.capacity] = old
            setattr(self, name, new)
        self.capacity = new_cap

    def add(self, vals_dict, loss, tid=None):
        """Ingest one completed trial: {label: value} + loss.

        Slots stay tid-ordered: an in-order tid appends; a late completion
        inserts at its tid position with one vectorized shift of the tail.
        A resident buffer stages an in-order append as an O(D) delta.
        """
        if self.count == self.capacity:
            self._grow()
        n = self.count
        if tid is None:
            tid = self.tids[n - 1] + 1 if n else 0
        i = int(np.searchsorted(self.tids[:n], tid))
        if i < n:  # late completion: shift the newer tail right by one
            self.values[:, i + 1: n + 1] = self.values[:, i:n]
            self.active[:, i + 1: n + 1] = self.active[:, i:n]
            self.losses[i + 1: n + 1] = self.losses[i:n]
            self.tids[i + 1: n + 1] = self.tids[i:n]
        self.values[:, i] = 0.0
        self.active[:, i] = False
        for label, v in vals_dict.items():
            d = self._label_pos.get(label)
            if d is None:
                continue
            self.values[d, i] = v
            self.active[d, i] = True
        self.losses[i] = loss
        self.tids[i] = tid
        self.valid[n] = True  # occupancy is a prefix mask
        self.count = n + 1
        self._generation += 1
        if self.resident:
            if i == n and len(self._pending_deltas) < MAX_PENDING_DELTAS:
                self._pending_deltas.append((
                    n, self.values[:, n].copy(), self.active[:, n].copy(),
                    float(loss),
                ))
            else:
                # a late insert shifted the tail, or the backlog is past
                # the crossover: re-materialize on next use
                self._resident_full = True
                self._pending_deltas.clear()

    def _add_doc(self, t):
        vals = {k: v[0] for k, v in t["misc"]["vals"].items() if len(v) == 1}
        self.add(vals, float(t["result"]["loss"]), tid=int(t["tid"]))

    def sync(self, trials: Trials):
        """Ingest trials completed since the last sync (a cursor over the
        trials list; docs seen while pending are revisited).  A shrunk
        list (``delete_all``) rebuilds from scratch.  Returns the number
        of newly ingested observations."""
        docs = trials.trials
        if len(docs) < self._n_scanned:
            self.__init__(self.space, MIN_CAPACITY, resident=self.resident)

        before = self.count
        still_pending = []
        for i in self._pending:
            t = docs[i]
            ps = posterior_state(t)
            if ps == "ok":
                self._add_doc(t)
            elif ps == "pending":
                still_pending.append(i)
        self._pending = still_pending

        for i in range(self._n_scanned, len(docs)):
            t = docs[i]
            ps = posterior_state(t)
            if ps == "ok":
                self._add_doc(t)
            elif ps == "pending":
                self._pending.append(i)
        self._n_scanned = len(docs)
        return self.count - before

    def arrays(self):
        """The four dense arrays at current (bucketed) capacity."""
        return self.values, self.active, self.losses, self.valid

    def _device_bucket(self, pow2_cap=None):
        """Width handed to the suggest program: the smallest power of two
        >= count (floored at MIN_CAPACITY, capped at capacity); past
        ``pow2_cap`` (the above-model compaction cap) it grows by
        GROWTH_FACTOR steps instead."""
        coarse = GROWTH_FACTOR.bit_length() - 1
        b = MIN_CAPACITY
        while b < self.count:
            b <<= 1 if (pow2_cap is None or b < pow2_cap) else coarse
        return min(b, self.capacity)

    def _full_upload(self, b):
        arrays = tuple(a[..., :b] for a in self.arrays())
        self.transfer_bytes_total += sum(a.nbytes for a in arrays)
        self.full_uploads += 1
        return _upload(arrays, self.space.device)

    def device_arrays(self, pow2_cap=None):
        """The four arrays as a :class:`HistoryState` on the space's
        device, sliced to the bucket of the live count.  Re-upload mode
        caches by (generation, bucket): repeated asks against unchanged
        history transfer nothing.  Resident mode returns the mirror with
        its staged deltas applied (:meth:`_resident_sync`)."""
        if self.resident:
            return self._resident_sync(pow2_cap)
        b = self._device_bucket(pow2_cap)
        key = (self._generation, b)
        if self._device_cache is None or self._device_cache[0] != key:
            self._device_cache = (key, self._full_upload(b))
        return self._device_cache[1]

    def set_resident(self, flag):
        """Flip the device view between resident and re-upload.  The host
        arrays are authoritative either way, so flipping is always safe:
        the next :meth:`device_arrays` (re)materializes the active view."""
        flag = bool(flag)
        if flag == self.resident:
            return
        self.resident = flag
        self._resident = None
        self._resident_full = True
        self._pending_deltas = []
        self._device_cache = None

    _DELTA_BYTES_FIXED = 8  # loss float32 + slot index int32

    def _delta_nbytes(self, vcol, acol):
        return vcol.nbytes + acol.nbytes + self._DELTA_BYTES_FIXED

    def _materialize_resident(self, b):
        self._resident = {"bucket": b, "arrays": self._full_upload(b)}
        self._pending_deltas.clear()
        self._resident_full = False

    def _resident_sync(self, pow2_cap=None):
        """Bring the mirror up to date and return it: a full upload when
        it is cold, at a bucket change and after a late insert or a long
        backlog; else each staged delta written in place."""
        b = self._device_bucket(pow2_cap)
        st = self._resident
        if st is None or st["bucket"] != b or self._resident_full:
            self._materialize_resident(b)
        elif self._pending_deltas:
            for slot, vcol, acol, loss in self._pending_deltas:
                apply_delta(*st["arrays"], vcol, acol, loss, slot)
                self.transfer_bytes_total += self._delta_nbytes(vcol, acol)
                self.delta_tells += 1
                self.dispatch_count += 1
            self._pending_deltas.clear()
        return self._resident["arrays"]

    def take_fusable_delta(self, pow2_cap=None):
        """Pop the single pending delta for a fused tell+ask.

        Returns ``(state, (vcol, acol, loss, slot))`` -- the mirror and the
        staged delta -- when the mirror exists at the current bucket and
        exactly one in-order tell is pending; the caller feeds both to a
        ``state_io`` suggest function and installs its state outputs with
        :meth:`commit_resident`.  Returns None otherwise (cold mirror,
        bucket growth, zero or several pending tells).
        """
        if not self.resident or self._resident_full or self._resident is None:
            return None
        if len(self._pending_deltas) != 1:
            return None
        if self._resident["bucket"] != self._device_bucket(pow2_cap):
            return None
        slot, vcol, acol, loss = self._pending_deltas.pop()
        self.transfer_bytes_total += self._delta_nbytes(vcol, acol)
        self.delta_tells += 1
        return self._resident["arrays"], (vcol, acol, loss, slot)

    def commit_resident(self, arrays):
        """Install a fused function's state outputs as the mirror (the
        counterpart of :meth:`take_fusable_delta`)."""
        self._resident["arrays"] = HistoryState(*arrays)

    def __getstate__(self):
        # device-side state never pickles; mirrors rebuild on first use
        state = self.__dict__.copy()
        state["_device_cache"] = None
        state["_resident"] = None
        state["_resident_full"] = True
        state["_pending_deltas"] = []
        return state


class TorchTrials(Trials):
    """``Trials`` that owns one :class:`ObsBuffer` per compiled space (the
    counterpart of :class:`hyperopt_tpu.jax_trials.JaxTrials`).

    ``resident=True`` makes every owned buffer device-resident: tells
    stage O(D) deltas instead of invalidating the device copy, which is
    what the fused sequential driver (``tpe.suggest(fused=True)``) wants.
    """

    def __init__(self, exp_key=None, refresh=True, resident=False):
        self._buffers = {}  # id(PackedSpace) -> ObsBuffer
        self._resident_default = bool(resident)
        super().__init__(exp_key=exp_key, refresh=refresh)

    def obs_buffer(self, space, resident=None):
        buf = self._buffers.get(id(space))
        if buf is None:
            buf = self._restore_stashed(space)
            if buf is None:
                buf = ObsBuffer(space, resident=self._resident_default)
            self._buffers[id(space)] = buf
        if resident is not None:
            buf.set_resident(resident)
        buf.sync(self)
        return buf

    def _restore_stashed(self, space):
        """A buffer rebuilt from a checkpoint bundle's ``.npz`` bytes
        (:meth:`~hyperopt_tpu_torch.utils.checkpoint.DriverRecovery.load`
        stashes them on the unpickled store): ``sync`` then ingests only
        the WAL-replayed suffix.  A blob of another space is skipped."""
        blobs = getattr(self, "_stashed_obs_npz", None)
        if not blobs:
            return None
        from .utils.checkpoint import load_obs_buffer_bytes

        for i, blob in enumerate(blobs):
            try:
                buf = load_obs_buffer_bytes(space, blob)
            except ValueError:
                continue
            blobs.pop(i)
            buf.set_resident(self._resident_default)
            return buf
        return None

    def __getstate__(self):
        # buffers are derived state; rebuilt on demand after unpickling
        state = self.__dict__.copy()
        state["_buffers"] = {}
        state.pop("_stashed_obs_npz", None)
        return state


def packed_space_for(domain):
    """Compile (once) and cache the domain's space on its device."""
    ps = getattr(domain, "_torch_packed_space", None)
    if ps is None:
        ps = compile_space(domain.expr, device=domain.device)
        domain._torch_packed_space = ps
    return ps


def obs_buffer_for(domain, trials, resident=None):
    """The domain's history buffer for ``trials``, synced: the
    :class:`TorchTrials` store's own buffer, else one cached on the domain
    and keyed on the trials-store identity (a weakref), so a Domain reused
    across two stores never serves one store's observations for the
    other.  ``resident`` (None = leave as is) flips the buffer's device
    view (:meth:`ObsBuffer.set_resident`)."""
    space = packed_space_for(domain)
    if isinstance(trials, TorchTrials):
        return trials.obs_buffer(space, resident=resident)
    cached = getattr(domain, "_torch_obs_buffer", None)
    buf = None
    if cached is not None:
        ref, buf_cached = cached
        if ref() is trials and buf_cached.space is space:
            buf = buf_cached
    if buf is None:
        buf = ObsBuffer(space)
        domain._torch_obs_buffer = (weakref.ref(trials), buf)
    if resident is not None:
        buf.set_resident(resident)
    buf.sync(trials)
    return buf


def cached_suggest_fn(domain, cache_attr, params, builder):
    """Per-domain cache of built suggest functions: ``params`` is the
    hashable hyperparameter tuple, keyed with the compiled-space identity;
    ``builder(packed_space, *params)`` builds the function."""
    ps = packed_space_for(domain)
    key = (id(ps),) + tuple(params)
    cache = getattr(domain, cache_attr, None)
    if cache is None:
        cache = {}
        setattr(domain, cache_attr, cache)
    fn = cache.get(key)
    if fn is None:
        fn = builder(ps, *params)
        cache[key] = fn
    return fn


# ---------------------------------------------------------------------------
# Program registration (hyperopt-tpu-torch-lint --ir)
# ---------------------------------------------------------------------------

from .ops.compile import ProgramCapture, register_program  # noqa: E402


@register_program(
    "torch_trials.apply_delta",
    families=("hyperopt_tpu_torch.ops.kernels:apply_delta",),
)
def _registry_apply_delta(p):
    """The O(D) delta tell the resident history runs per staged
    observation (:meth:`ObsBuffer._resident_sync`): the four history
    tensors written in place."""
    return ProgramCapture(fn=apply_delta, args=p.history_specs(), kwargs=p.delta_specs(),
                          mutates=(0, 1, 2, 3))
