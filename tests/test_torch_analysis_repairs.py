"""The repairs the port's own lint packs forced, each held by a test.

* GL303 in ``distributed/_common.with_retries``: the backoff slept
  through a bare ``time.sleep``.  It goes through a ``sleep`` seam now
  (the reference's name for it), so the schedule is checked here
  without waiting on it.

The ``Overloaded`` reply's back-off floor was rewritten to the shape
GL606 reads (``min(0.05, RETRY_AFTER_CAP)``, the idiom of the service's
other hints) with no change in behaviour; the parity case below holds
the reply to the reference's.
"""

import errno

import pytest

from hyperopt_tpu.exceptions import Overloaded as RefOverloaded
from hyperopt_tpu.serve.service import _serve_error_reply as ref_reply
from hyperopt_tpu_torch.distributed import _common
from hyperopt_tpu_torch.exceptions import FatalBackendError, Overloaded
from hyperopt_tpu_torch.serve.service import RETRY_AFTER_CAP, _serve_error_reply


def _flaky(n_failures, exc):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= n_failures:
            raise exc
        return len(calls)

    return fn, calls


def test_with_retries_backoff_goes_through_the_sleep_seam():
    slept = []
    fn, calls = _flaky(4, OSError(errno.ESTALE, "stale handle"))
    assert _common.with_retries(fn, sleep=slept.append) == 5
    assert slept == [_common.retry_delay(a) for a in range(4)]
    assert slept == [0.005, 0.01, 0.02, 0.04]


def test_with_retries_defaults_and_attempt_budget():
    slept = []
    fn, calls = _flaky(99, TimeoutError(errno.ETIMEDOUT, "slow mount"))
    with pytest.raises(TimeoutError):
        _common.with_retries(fn, sleep=slept.append)
    assert len(calls) == _common.RETRY_ATTEMPTS and len(slept) == _common.RETRY_ATTEMPTS - 1
    assert max(slept) == _common.RETRY_MAX_S


def test_with_retries_propagates_fatal_and_decode_errors():
    slept = []
    fn, calls = _flaky(1, FatalBackendError("gone"))
    with pytest.raises(FatalBackendError):
        _common.with_retries(fn, sleep=slept.append)
    assert len(calls) == 1 and slept == []
    fn, calls = _flaky(2, ValueError("decode"))
    with pytest.raises(ValueError):
        _common.with_retries(fn, sleep=slept.append)
    assert len(calls) == 1 and slept == []


@pytest.mark.parametrize("retry_after", [None, 0.0, 0.2, 7.5])
def test_overloaded_reply_is_the_reference_reply(retry_after):
    for reason in ("queue_full", "draining"):
        mine = _serve_error_reply(Overloaded("busy", retry_after=retry_after, reason=reason))
        theirs = ref_reply(RefOverloaded("busy", retry_after=retry_after, reason=reason))
        assert mine == theirs
    floor = _serve_error_reply(Overloaded("busy"))["retry_after"]
    assert floor == 0.05 and floor <= RETRY_AFTER_CAP
