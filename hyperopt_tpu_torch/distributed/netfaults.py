"""Seeded, deterministic network fault injection.

The port's copy of :mod:`hyperopt_tpu.distributed.netfaults`, decision
for decision: for one seed and one sequence of operations on each
connection, :class:`NetFaultPlan` injects the faults the reference's
does (the same ``random.Random`` streams, derived by crc32).

The socket twin of :mod:`.faults`: where ``FaultPlan`` corrupts the
filesystem seam, ``NetFaultPlan`` corrupts the wire.  It wraps the
``makefile`` handle of every connection it is given (the study client's
:func:`~hyperopt_tpu_torch.serve.frames.dial`, the server front's
accepted connections) and injects:

* **reset** -- the peer resets the connection mid-frame: a write puts
  only a prefix on the wire, then ``ConnectionResetError``; a read
  raises it at once;
* **latency** -- a bounded read/write delay (capped at 50 ms);
* **truncate-then-close** -- a prefix of the frame reaches the peer and
  the socket is hard-closed: the reader sees a torn frame, the writer
  ``BrokenPipeError``;
* **black-hole partition** -- connected but silent: writes are
  swallowed, reads time out (keyed, and healable at run time with
  :meth:`NetFaultPlan.partition` / :meth:`NetFaultPlan.heal`);
* **slow loris** -- byte-at-a-time writes of each frame's prefix.

Fault schedules are a pure function of ``(seed, connection key,
connection ordinal, that connection's own op sequence)``: each wrapped
connection draws from its own RNG stream, so decisions do not depend on
how threads interleave across connections.  Every decision lands in
``plan.log``, and counts in ``plan.stats``.  Fault streaks are
burst-bounded per (op, connection): a retry loop of ``burst + 1``
attempts always converges.

``NET_CRASH_POINTS`` bracket the client's send/ack window:

``net_client_after_send_before_reply``
    the request bytes are on the wire but no reply arrived: a restarted
    client resubmits (asks with ``recover=True``, tells with explicit
    ``vals``) and the service deduplicates.

``net_client_after_reply_before_deliver``
    the reply arrived but the client died before acting on it: the ack
    is lost after the service committed, and the resubmission is
    absorbed exactly once (the WAL's tid dedup).

:mod:`.faults` imports this module to re-export the plan and extend
``ALL_CRASH_POINTS``; this module imports ``SimulatedCrash`` and
``ALL_CRASH_POINTS`` from :mod:`.faults` inside its methods.
"""

import logging
import random
import socket
import threading
import time
import zlib

import collections

logger = logging.getLogger(__name__)

__all__ = [
    "NET_CRASH_POINTS", "NetFaultPlan", "FaultyWire",
]

#: crash points bracketing the client's send/ack window (see module
#: docstring) -- merged into ``faults.ALL_CRASH_POINTS`` so the chaos
#: suites' registration pin covers them.
NET_CRASH_POINTS = (
    "net_client_after_send_before_reply",
    "net_client_after_reply_before_deliver",
)

#: injected latency is capped here (matches ``FaultPlan``): chaos
#: suites must not acquire real multi-second sleeps.
_LATENCY_CAP = 0.05

#: slow-loris shape: this many leading bytes of each write go out
#: one at a time with a per-byte delay; the remainder is written
#: normally so the total injected stall stays inside the cap.
_LORIS_PREFIX = 24
_LORIS_BYTE_DELAY = 0.002


class NetFaultPlan:
    """A seeded, deterministic schedule of network faults.

    One plan = one family of per-connection RNG streams: with a fixed
    seed and a fixed per-connection op sequence, the injected faults
    are identical run to run regardless of thread interleaving across
    connections.

    Parameters:
      seed:          RNG seed (determinism anchor).
      reset_rate:    probability a read/write dies with
                     ``ConnectionResetError`` (writes put a prefix on
                     the wire first -- the mid-frame case).
      latency:       max injected delay per socket op, seconds (capped
                     at 50 ms).
      truncate_rate: probability a write sends only a prefix and then
                     hard-closes the socket (torn frame on the peer).
      burst:         max *consecutive* injected faults per (op, conn);
                     bounds the adversary so ``burst + 1`` retries
                     always converge.  ``None`` = unbounded.
    """

    def __init__(self, seed=0, reset_rate=0.0, latency=0.0,
                 truncate_rate=0.0, burst=2):
        self.seed = seed
        self.reset_rate = float(reset_rate)
        self.latency = min(float(latency), _LATENCY_CAP)
        self.truncate_rate = float(truncate_rate)
        self.burst = burst
        self._lock = threading.RLock()
        self._ordinals = {}        # key -> next conn ordinal
        self._partitioned = set()  # keys currently black-holed
        self._loris = set()        # keys writing byte-at-a-time
        self._crash = {}
        self.log = []
        self.stats = collections.Counter()

    # -- derivation --------------------------------------------------------
    def split(self, name):
        """A derived plan with the same fault profile and a stably
        derived seed (crc32, not ``hash()`` -- PYTHONHASHSEED must not
        leak into the schedule).  Crash points and partition/loris
        marks are NOT inherited."""
        child_seed = zlib.crc32(f"{self.seed}/{name}".encode())
        return NetFaultPlan(
            seed=child_seed, reset_rate=self.reset_rate,
            latency=self.latency, truncate_rate=self.truncate_rate,
            burst=self.burst,
        )

    # -- chaos shapes ------------------------------------------------------
    def partition(self, key):
        """Black-hole every connection under ``key`` from now on:
        connected but silent (writes swallowed, reads time out): the
        process behind it keeps running."""
        with self._lock:
            self._partitioned.add(key)
            self.log.append(("partition", key, "on"))
            self.stats["net:partition"] += 1
        return self

    def heal(self, key=None):
        """Lift the partition for ``key`` (or all keys): live
        connections resume passing bytes on their next op -- no
        reconnect required, exactly like a switch port coming back."""
        with self._lock:
            healed = [key] if key is not None else sorted(self._partitioned)
            if key is None:
                self._partitioned.clear()
            else:
                self._partitioned.discard(key)
            for k in healed:
                self.log.append(("partition", k, "healed"))
        return self

    def is_partitioned(self, key):
        with self._lock:
            return key in self._partitioned

    def slow_loris(self, key):
        """Mark ``key``'s connections as slow-loris writers: the first
        bytes of every write trickle out one at a time."""
        with self._lock:
            self._loris.add(key)
            self.log.append(("slow_loris", key, "on"))
        return self

    def is_loris(self, key):
        with self._lock:
            return key in self._loris

    # -- crash points ------------------------------------------------------
    def arm(self, point, at=1):
        """Arm a one-shot crash at the ``at``-th hit of ``point``."""
        from .faults import ALL_CRASH_POINTS
        if point not in ALL_CRASH_POINTS:
            raise ValueError(f"unknown crash point {point!r}")
        with self._lock:
            self._crash[point] = int(at)
        return self

    def fire_crashpoint(self, name):
        from .faults import SimulatedCrash
        with self._lock:
            if name not in self._crash:
                return
            self._crash[name] -= 1
            if self._crash[name] > 0:
                return
            del self._crash[name]
            self.log.append(("crash", name, "fired"))
            self.stats[f"crash:{name}"] += 1
        raise SimulatedCrash(name)

    # -- wrapping ----------------------------------------------------------
    def _conn_state(self, key):
        with self._lock:
            ordinal = self._ordinals.get(key, 0)
            self._ordinals[key] = ordinal + 1
        conn_seed = zlib.crc32(f"{self.seed}/{key}/{ordinal}".encode())
        return _ConnState(self, key, ordinal, random.Random(conn_seed))

    def wrap(self, f, sock=None, key=None):
        """Wrap one ``makefile('rwb')`` handle in the fault seam."""
        return FaultyWire(f, self._conn_state(key or "conn"), sock=sock)

    def wrap_pair(self, rfile, wfile, sock=None, key=None):
        """Wrap a server handler's (rfile, wfile) pair: one connection
        ordinal, one RNG stream shared by both directions -- the fault
        schedule stays a function of the connection's op sequence."""
        st = self._conn_state(key or "conn")
        return FaultyWire(rfile, st, sock=sock), FaultyWire(wfile, st, sock=sock)

    # -- decision engine (called by FaultyWire) ----------------------------
    def _decide(self, st, op):
        """One burst-bounded draw on ``st``'s own RNG stream: ``None``
        or the fault to inject (``"reset"``; writes may also draw
        ``"truncate"``).  A single streak key per (op, conn) keeps the
        ``burst + 1``-retries-converge guarantee even with both rates
        set."""
        with self._lock:
            trunc = self.truncate_rate if op == "write" else 0.0
            total = self.reset_rate + trunc
            if not total:
                return None
            streak = st.streaks.get(op, 0)
            allowed = self.burst is None or streak < self.burst
            r = st.rng.random()
            if allowed and r < total:
                st.streaks[op] = streak + 1
                fault = "reset" if r < self.reset_rate else "truncate"
                self.log.append((op, st.tag, fault))
                self.stats[f"net:{fault}"] += 1
                return fault
            st.streaks[op] = 0
            self.log.append((op, st.tag, "ok"))
            return None

    def _decide_latency(self, st):
        if not self.latency:
            return 0.0
        with self._lock:
            return st.rng.uniform(0.0, self.latency)


class _ConnState:
    """Per-connection fault state: own RNG stream, own burst streaks,
    shared (under the plan lock) by both directions of a server pair."""

    __slots__ = ("plan", "key", "ordinal", "rng", "streaks", "tag")

    def __init__(self, plan, key, ordinal, rng):
        self.plan = plan
        self.key = key
        self.ordinal = ordinal
        self.rng = rng
        self.streaks = {}
        self.tag = f"{key}#{ordinal}"


class FaultyWire:
    """File-object proxy that injects the plan's network faults.

    Wraps a socket ``makefile`` handle (or a handler's rfile/wfile):
    reads and writes consult the plan first, then delegate.  Unknown
    attributes pass through, so it is drop-in wherever the raw handle
    was (``FrameConn``, ``StreamRequestHandler``).
    """

    def __init__(self, f, state, sock=None):
        self._f = f
        self._st = state
        self._sock = sock
        self._plan = state.plan

    # -- read side ---------------------------------------------------------
    def _pre_read(self):
        plan, st = self._plan, self._st
        if plan.is_partitioned(st.key):
            # connected but silent: block for the latency budget, then
            # miss the deadline the way a real black hole does
            time.sleep(plan.latency or 0.01)
            plan.stats["net:blackhole_read"] += 1
            raise socket.timeout(f"black hole: {st.tag}")
        if plan._decide(st, "read") == "reset":
            raise ConnectionResetError(f"injected reset (read): {st.tag}")
        lat = plan._decide_latency(st)
        if lat:
            time.sleep(lat)

    def read(self, n=-1):
        self._pre_read()
        data = self._f.read(n)
        if data:
            self._plan.fire_crashpoint("net_client_after_reply_before_deliver")
        return data

    def readline(self, limit=-1):
        self._pre_read()
        data = self._f.readline(limit)
        if data:
            self._plan.fire_crashpoint("net_client_after_reply_before_deliver")
        return data

    # -- write side --------------------------------------------------------
    def write(self, b):
        plan, st = self._plan, self._st
        if plan.is_partitioned(st.key):
            # swallowed by the black hole: locally "successful"
            plan.stats["net:blackhole_write"] += 1
            return len(b)
        fault = plan._decide(st, "write")
        if fault == "reset":
            self._tear(b)
            raise ConnectionResetError(f"injected reset (write): {st.tag}")
        if fault == "truncate":
            self._tear(b)
            self._hard_close()
            raise BrokenPipeError(f"injected truncate-then-close: {st.tag}")
        lat = plan._decide_latency(st)
        if lat:
            time.sleep(lat)
        if plan.is_loris(st.key) and len(b) > 1:
            head = b[:_LORIS_PREFIX]
            for i in range(len(head)):
                self._f.write(head[i:i + 1])
                self._f.flush()
                time.sleep(_LORIS_BYTE_DELAY)
            self._f.write(b[_LORIS_PREFIX:])
            return len(b)
        return self._f.write(b)

    def _tear(self, b):
        """Put a prefix on the wire before dying: the mid-frame case
        (the peer's ``_read_exact`` sees a torn frame, not clean EOF)."""
        st = self._st
        cut = st.rng.randrange(0, max(len(b), 1))
        if cut:
            try:
                self._f.write(b[:cut])
                self._f.flush()
            except OSError:
                pass

    def _hard_close(self):
        try:
            if self._sock is not None:
                self._sock.close()
            self._f.close()
        except OSError:
            pass

    def flush(self):
        if self._plan.is_partitioned(self._st.key):
            return
        self._f.flush()
        self._plan.fire_crashpoint("net_client_after_send_before_reply")

    # -- passthrough -------------------------------------------------------
    def close(self):
        self._f.close()

    @property
    def closed(self):
        return self._f.closed

    def __getattr__(self, name):
        return getattr(self._f, name)
