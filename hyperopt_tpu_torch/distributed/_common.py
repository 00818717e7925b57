"""Shared mechanics of the port's fault domain (copies of
:mod:`hyperopt_tpu.distributed._common`).

The retry half: transient-versus-fatal classification of failures and
the bounded retry around it.  The serve scheduler's watchdog retries a
round once on a transient failure and never on a deterministic one; the
write-ahead log, the durable bundles and every job-queue operation retry
a transient filesystem or database fault with a capped backoff.

The worker half, shared by the file-queue and Mongo workers so the two
transports cannot drift: which Domain a job doc names
(:func:`blob_key_from_doc`), a cooldown set for jobs whose Domain would
not load (:class:`TTLSet`), a heartbeat that keeps a reserved job's claim
alive through a long evaluation (:func:`claim_heartbeat`), and a small
identity-validated Domain cache (:func:`lru_get`).
"""

from __future__ import annotations

import collections
import contextlib
import errno
import logging
import threading
import time

from ..exceptions import FatalBackendError, TransientBackendError

logger = logging.getLogger(__name__)

__all__ = ["DEFAULT_DOMAIN_KEY", "RETRY_ATTEMPTS", "TRANSIENT_ERRNOS", "TTLSet",
           "blob_key_from_doc", "claim_heartbeat", "is_transient", "lru_get", "retry_delay",
           "with_retries"]

#: the attachment under which ``fmin`` publishes its pickled Domain
DEFAULT_DOMAIN_KEY = "FMinIter_Domain"

# the errno classes a flaky mount or transport emits for operations that
# are perfectly retryable; ENOENT is deliberately absent (a lost race is
# a protocol signal, not a blip)
TRANSIENT_ERRNOS = frozenset({
    errno.ESTALE, errno.EIO, errno.EAGAIN, errno.EINTR, errno.EBUSY,
    errno.ETIMEDOUT, errno.ECONNRESET, errno.ENOBUFS, errno.EREMOTEIO,
})

# retryable exception classes of a database client library, matched by
# name so the library stays an optional dependency
_TRANSIENT_NAMES = frozenset({"AutoReconnect", "NetworkTimeout", "NotPrimaryError"})


def is_transient(exc):
    """True for a retryable blip, False for a real failure."""
    if isinstance(exc, FatalBackendError):
        return False
    if isinstance(exc, TransientBackendError):
        return True
    if isinstance(exc, OSError):
        return exc.errno in TRANSIENT_ERRNOS
    return any(c.__name__ in _TRANSIENT_NAMES for c in type(exc).__mro__)


#: calls of :func:`with_retries`, and its backoff: 5 ms doubling, capped at 50 ms
RETRY_ATTEMPTS, RETRY_BASE_S, RETRY_MAX_S = 10, 0.005, 0.05


def retry_delay(attempt, base_delay=RETRY_BASE_S, max_delay=RETRY_MAX_S):
    """The backoff before retry ``attempt + 1``: ``base_delay`` doubling,
    capped at ``max_delay`` (the workers' crash-loop guards pass their
    poll interval and 2 s)."""
    return min(float(max_delay), float(base_delay) * 2 ** int(attempt))


def with_retries(fn, label=None, sleep=time.sleep):
    """Call ``fn()``; on a transient failure (:func:`is_transient`) retry
    with exponential backoff, up to :data:`RETRY_ATTEMPTS` calls in all.
    Anything else (a lost race, a decode error, a
    :class:`FatalBackendError`, a simulated crash) propagates at once.
    ``sleep`` is the backoff's seam: a test passes a recorder, so the
    schedule is checked without waiting on it."""
    for attempt in range(RETRY_ATTEMPTS):
        try:
            return fn()
        except Exception as e:
            if attempt == RETRY_ATTEMPTS - 1 or not is_transient(e):
                raise
            delay = retry_delay(attempt)
            logger.debug("transient failure in %s (attempt %d/%d), retrying in %.0f ms: %s",
                         label or getattr(fn, "__name__", "op"), attempt + 1, RETRY_ATTEMPTS,
                         delay * 1e3, e)
            sleep(delay)


def blob_key_from_doc(doc):
    """The Domain attachment a trial doc names (its ``misc["cmd"]``):
    drivers with different objectives share one queue, each doc resolving
    its own."""
    cmd = (doc.get("misc") or {}).get("cmd") or (None, None)
    return cmd[1] if cmd[0] == "domain_attachment" else DEFAULT_DOMAIN_KEY


class TTLSet:
    """Keys on cooldown: ``add`` starts a key's TTL, ``current()`` prunes
    and returns the live keys.  A worker keeps the tids of jobs whose
    Domain would not load here: excluded from its reservations long
    enough to stop a livelock on the lowest tid, retried afterwards in
    case the failure was transient."""

    def __init__(self, ttl=300.0, clock=time.monotonic):
        self.ttl = float(ttl)
        self._clock = clock
        self._seen = {}

    def add(self, key):
        self._seen[key] = self._clock()

    def current(self):
        now = self._clock()
        self._seen = {k: ts for k, ts in self._seen.items() if now - ts < self.ttl}
        return list(self._seen)


@contextlib.contextmanager
def claim_heartbeat(beat, interval):
    """Run ``beat()`` every ``interval`` seconds on a daemon thread for the
    duration of the with-block, so a reserved job's claim stays visibly
    alive through an evaluation longer than the reserve timeout and only
    dead workers' jobs are reaped.  ``beat`` returns False to stop early
    (the claim is gone); an exception is logged and beating continues (a
    frozen beat would get a live job reaped and run twice).
    ``interval=None`` disables the heartbeat."""
    if interval is None:
        yield
        return
    stop = threading.Event()

    def loop():
        while not stop.wait(float(interval)):
            try:
                if beat() is False:
                    return
            except Exception as e:  # graftlint: disable=GL302 the beat must outlive any transport error
                logger.warning("claim heartbeat failed transiently: %s", e)

    th = threading.Thread(target=loop, daemon=True)
    th.start()
    try:
        yield
    finally:
        stop.set()
        th.join(timeout=5)


def lru_get(cache, key, ident, load, cap=8):
    """Identity-validated LRU lookup: ``cache[key]``'s value if its
    recorded identity equals ``ident``, else ``load()`` stored with
    ``ident``.  Entries past ``cap`` are evicted least recently used first,
    so a long-lived worker serving many drivers does not hold every run's
    Domain.  ``cache`` is a ``collections.OrderedDict``."""
    assert isinstance(cache, collections.OrderedDict)
    hit = cache.get(key)
    if hit is None or hit[0] != ident:
        hit = (ident, load())
        cache[key] = hit
    cache.move_to_end(key)
    while len(cache) > cap:
        cache.popitem(last=False)
    return hit[1]
