"""Transient-versus-fatal classification of failures and the bounded
retry around it (copies of :func:`hyperopt_tpu.distributed._common.
is_transient`, ``retry_delay`` and ``with_retries``): the serve
scheduler's watchdog retries a round once on a transient failure and
never on a deterministic one, and the write-ahead log and the durable
bundles retry a transient filesystem fault with a capped backoff."""

from __future__ import annotations

import errno
import logging
import time

from ..exceptions import FatalBackendError, TransientBackendError

logger = logging.getLogger(__name__)

__all__ = ["RETRY_ATTEMPTS", "TRANSIENT_ERRNOS", "is_transient", "retry_delay", "with_retries"]

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


def retry_delay(attempt):
    """The backoff before retry ``attempt + 1``."""
    return min(RETRY_MAX_S, RETRY_BASE_S * 2 ** int(attempt))


def with_retries(fn, label=None):
    """Call ``fn()``; on a transient failure (:func:`is_transient`) retry
    with exponential backoff, up to :data:`RETRY_ATTEMPTS` calls in all.
    Anything else (a lost race, a decode error, a
    :class:`FatalBackendError`, a simulated crash) propagates at once."""
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
            time.sleep(delay)
