"""Exception types of the PyTorch port (a copy of
:mod:`hyperopt_tpu.exceptions`, so the port imports nothing of the JAX
package)."""


class HyperoptTpuError(Exception):
    """Base class for all errors of the package."""


class PyllImportError(HyperoptTpuError):
    """A pyll graph references an unknown scope symbol."""


class DuplicateLabel(HyperoptTpuError):
    """The same hyperparameter label was used for two different nodes."""


class InvalidTrial(HyperoptTpuError, ValueError):
    """A trial document failed validation."""


class InvalidResultStatus(HyperoptTpuError, ValueError):
    """An objective returned a result dict with a bad ``status``."""


class InvalidLoss(HyperoptTpuError, ValueError):
    """An objective returned a loss that is not a finite float (or None)."""


class InvalidAnnotatedParameter(HyperoptTpuError, ValueError):
    """An ``hp.*`` call was malformed (bad label or arguments)."""


class AllTrialsFailed(HyperoptTpuError):
    """Every trial in the experiment errored; there is no argmin."""


class CompileError(HyperoptTpuError):
    """The space compiler could not lower a search space to a JAX sampler."""


class CheckpointError(HyperoptTpuError):
    """A checkpoint / write-ahead-log artifact could not be used for
    resume: truncated or corrupt pickle, torn mid-file WAL record, or a
    guard-fingerprint mismatch (the snapshot belongs to a different
    space/algo/objective).  The message names the offending file and,
    when one exists, the last-good artifact to fall back to."""


class TrialTimeout(HyperoptTpuError):
    """A single objective evaluation exceeded the driver's per-trial
    deadline (``fmin(trial_timeout=...)``); recorded as a STATUS_FAIL
    trial, never propagated."""


class BackendError(HyperoptTpuError):
    """A distributed-transport (filequeue / mongo) operation failed.

    The transient-vs-fatal split below is the contract
    ``distributed._common.with_retries`` classifies by: transient
    failures (mount blips, reconnects) are retried with exponential
    backoff, fatal ones surface immediately."""


class TransientBackendError(BackendError):
    """A retryable transport failure (the ESTALE/EIO/AutoReconnect
    class): raise this to ask the retry scaffold for another attempt."""


class FatalBackendError(BackendError):
    """A non-retryable transport failure (corruption, permission,
    protocol violation): never retried, always surfaced."""


class ClaimLost(BackendError):
    """A worker's reservation was reaped (and possibly re-claimed)
    while it was still evaluating -- detected at completion time so the
    stale worker drops its result instead of racing the re-run into a
    duplicate DONE doc."""


class ServeError(HyperoptTpuError):
    """Base of the suggestion service's runtime-protection (graftguard)
    errors.  Every one is a *structured refusal*: the service stays
    healthy, the client gets a typed reason and (where it makes sense)
    a hint about what to do next."""


class Overloaded(ServeError):
    """The service refused to admit an ask: the bounded queue is at its
    high-water mark, the study hit its fairness cap, the batcher's
    circuit breaker is open, or the service is draining for a rolling
    restart.  ``retry_after`` (seconds, may be None while draining) is
    computed from current queue occupancy and the p50 ask latency --
    back off that long and resubmit.  ``reason`` is one of
    ``queue_full`` / ``study_queue_cap`` / ``circuit_open`` /
    ``draining``."""

    def __init__(self, message, retry_after=None, reason="queue_full"):
        super().__init__(message)
        self.retry_after = retry_after
        self.reason = reason


class DeadlineExpired(ServeError):
    """An ask's client deadline passed before the service could serve
    it -- shed at submit (already expired) or dropped from the queue
    (expired while waiting) instead of wasting a dispatch slot on an
    answer nobody is waiting for."""


class StudyPoisoned(ServeError):
    """The fused finite-check caught non-finite values in this study's
    slot (its resident history or this round's suggestion): the ask is
    failed back to this client only, the slot re-materializes from
    host truth, and sibling slots are untouched."""


class StudyQuarantined(StudyPoisoned):
    """The study tripped the finite-check K consecutive times and was
    evicted from the slotted batch (its host truth itself is poisoned,
    e.g. a told NaN loss).  Asks and tells are refused until the study
    is closed; sibling studies are unaffected."""


class DispatchTimeout(ServeError):
    """A device dispatch exceeded the scheduler's watchdog deadline.
    Treated as transient: the round retries once against a freshly
    re-materialized stacked state before failing the picked asks."""


class OwnershipLost(ServeError):
    """The serve-fleet twin of :class:`ClaimLost`: this replica's
    per-study claim/epoch token was taken over (failover or planned
    migration bumped the epoch), so the replica must drop the operation
    instead of double-serving a study it no longer owns.  A partitioned
    or zombie replica surfaces this on its next fenced ask/tell; the
    client retries through the router, which routes to the new owner."""


class ReplicaDead(ServeError):
    """A fleet replica marked dead (killed, crashed, or partitioned
    away from the router) was asked to serve: the router converts this
    into failover -- re-materializing the dead replica's studies on
    survivors -- and retries against the new owner."""


class NetworkTimeout(ServeError):
    """A socket read or write missed its deadline: the peer is
    connected but silent (black-hole partition, hung handler, or a
    slow-loris writer slower than the budget).  Raised instead of
    blocking a handler or client thread forever; routed into the same
    failover/retry machinery as a connection error -- the router marks
    the backend suspect and re-routes, the client resubmits with the
    exactly-once recover/re-tell discipline."""


class PeerUnreachable(ServeError):
    """A connection could not be established (refused, no route, DNS,
    or connect deadline) or was exhausted after bounded retries: the
    peer is gone rather than slow.  The terminal transport error a
    client surfaces when every retry budget is spent -- always typed,
    never a raw :class:`OSError`."""
