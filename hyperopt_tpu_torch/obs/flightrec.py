"""The flight recorder of the PyTorch port: only its disarmed form.

The reference's recorder (:mod:`hyperopt_tpu.obs.flightrec`) exports
spans through the write-ahead-log record format, so the armed recorder
arrives with the durability slice (``ROADMAP.md`` Queue A, item 12b).
Until then every call site holds :data:`NULL_RECORDER`, whose calls do
nothing, and the serve front refuses ``recorder=``.
"""

from __future__ import annotations

__all__ = ["NULL_RECORDER", "NullRecorder"]


class NullRecorder:
    """The disarmed recorder: every call is a no-op."""

    enabled = False

    def record(self, name, t0=None, t1=None, **ids):
        pass

    def event(self, name, **ids):
        pass

    def tail(self, n=None):
        return []

    def flush(self):
        pass

    def close(self):
        pass


NULL_RECORDER = NullRecorder()
