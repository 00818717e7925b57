"""Dense observation history of the PyTorch port.

The counterpart of :mod:`hyperopt_tpu.jax_trials`: :class:`ObsBuffer`
incrementally mirrors a ``Trials`` store (only completed, status-ok,
finite-loss trials enter the posterior) into preallocated dense numpy
buffers -- values + active masks per hyperparameter, losses + validity --
grown 4x at a time, and hands the suggest path a device copy sliced to a
power-of-two bucket of the live count.  This slice ports the re-upload
path: the device copy is rebuilt when the history changed and cached
while it did not.  The resident (delta-tell) mirror and the fused
tell+ask path are later work.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from .base import Trials, posterior_state
from .ops.compile import compile_space
from .ops.kernels import HistoryState

__all__ = [
    "GROWTH_FACTOR",
    "MIN_CAPACITY",
    "ObsBuffer",
    "cached_suggest_fn",
    "obs_buffer_for",
    "packed_space_for",
]

MIN_CAPACITY = 128
GROWTH_FACTOR = 4


class ObsBuffer:
    """Dense, capacity-bucketed mirror of completed trials for one space.

    Arrays (host numpy, the source of truth):
      values: [D, cap] natural-space draws (garbage where inactive)
      active: [D, cap] per-dim activity mask
      losses: [cap]
      valid:  [cap] slot occupancy
    Slots are tid-ordered (time order for forgetting weights).  The
    deterministic counters ``transfer_bytes_total`` / ``full_uploads`` /
    ``dispatch_count`` (plain ints) expose the host->device traffic and
    the suggest programs run against this buffer.
    """

    def __init__(self, space, capacity=MIN_CAPACITY):
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
        self.transfer_bytes_total = 0
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
            self.__init__(self.space, MIN_CAPACITY)

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

    def device_arrays(self, pow2_cap=None):
        """The four arrays as a :class:`HistoryState` on the space's
        device, sliced to the bucket of the live count and cached by
        (generation, bucket): repeated asks against unchanged history
        transfer nothing."""
        b = self._device_bucket(pow2_cap)
        key = (self._generation, b)
        if self._device_cache is None or self._device_cache[0] != key:
            arrays = tuple(np.ascontiguousarray(a[..., :b]) for a in self.arrays())
            self.transfer_bytes_total += sum(a.nbytes for a in arrays)
            self.full_uploads += 1
            dev = self.space.device
            self._device_cache = (
                key,
                HistoryState(*(torch.from_numpy(a).to(dev) for a in arrays)),
            )
        return self._device_cache[1]


def packed_space_for(domain):
    """Compile (once) and cache the domain's space on its device."""
    ps = getattr(domain, "_torch_packed_space", None)
    if ps is None:
        ps = compile_space(domain.expr, device=domain.device)
        domain._torch_packed_space = ps
    return ps


def obs_buffer_for(domain, trials):
    """The domain's history buffer for ``trials``, synced.

    Cached on the domain and keyed on the trials-store identity (a
    weakref): a Domain reused across two stores never serves one store's
    observations for the other."""
    space = packed_space_for(domain)
    cached = getattr(domain, "_torch_obs_buffer", None)
    buf = None
    if cached is not None:
        ref, buf_cached = cached
        if ref() is trials and buf_cached.space is space:
            buf = buf_cached
    if buf is None:
        buf = ObsBuffer(space)
        domain._torch_obs_buffer = (weakref.ref(trials), buf)
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
