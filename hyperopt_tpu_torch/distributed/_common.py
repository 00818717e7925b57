"""Transient-versus-fatal classification of failures (a copy of
:func:`hyperopt_tpu.distributed._common.is_transient`): the serve
scheduler's watchdog retries a round once on a transient failure and
never on a deterministic one."""

from __future__ import annotations

import errno

from ..exceptions import FatalBackendError, TransientBackendError

__all__ = ["TRANSIENT_ERRNOS", "is_transient"]

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
