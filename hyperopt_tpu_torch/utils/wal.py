"""Write-ahead tell log of the PyTorch port: :class:`TellWAL`.

The port's copy of :mod:`hyperopt_tpu.utils.wal`, record for record:
every ask the driver issues and every tell it applies is appended here
before the in-memory mutation it describes, so a driver or a serve study
killed at any instruction boundary resumes with zero lost and zero
duplicated tells, and, with the bit-generator cursor each ask record
carries, a suggestion stream bitwise the run that never crashed.

Record format (one line per record)::

    <crc32 of the json, 8 hex chars> <json body>\n

where the body is ``{"seq": n, ...payload}`` (keys sorted, no spaces:
the same bytes the reference writes for the same body).  The first
record of a file is a header (``{"seq": -1, "magic": ..., "guard": ...,
"base_seq": N, "base_tells": M}``); ``base_seq``/``base_tells`` carry the
monotone counters across :meth:`TellWAL.reset` compactions.

Torn-tail rule: a crash mid-append leaves a final line that is truncated
or fails its checksum; :meth:`TellWAL.recover` truncates exactly that
tail (tmp + fsync + rename) and replay proceeds from the valid prefix.
A checksum failure before the final record is corruption the protocol
cannot produce and raises :class:`~hyperopt_tpu_torch.exceptions.
CheckpointError`.  All filesystem access goes through the ``fs`` seam of
:mod:`hyperopt_tpu_torch.distributed.faults`.
"""

from __future__ import annotations

import json
import logging
import os
import zlib

from ..distributed import _common
from ..distributed.faults import REAL_FS
from ..exceptions import CheckpointError

logger = logging.getLogger(__name__)

__all__ = ["TellWAL", "WAL_MAGIC"]

WAL_MAGIC = "hyperopt-tpu-wal-1"


def _encode_record(body):
    data = json.dumps(body, sort_keys=True, separators=(",", ":"))
    crc = zlib.crc32(data.encode("utf-8")) & 0xFFFFFFFF
    return f"{crc:08x} {data}\n"


def _decode_line(line):
    """The parsed body, or None for a torn/garbled line."""
    if not line.endswith("\n"):
        return None
    try:
        crc_hex, data = line[:-1].split(" ", 1)
        if int(crc_hex, 16) != zlib.crc32(data.encode("utf-8")) & 0xFFFFFFFF:
            return None
        body = json.loads(data)
    except (ValueError, json.JSONDecodeError):
        return None
    return body if isinstance(body, dict) else None


class TellWAL:
    """Append-only, checksummed, fsync-durable record log at ``path``.

    ``append`` assigns monotone sequence numbers that survive
    :meth:`reset` compaction (the checkpoint absorbs a prefix; the
    header of the rewritten file carries the base counters forward).
    ``guard`` is the study fingerprint stamped into the header --
    replaying a log written by a different space/algo must be refused,
    never silently reinterpreted.
    """

    def __init__(self, path, fs=REAL_FS, guard=None):
        self.path = path
        self.fs = fs
        self.guard = list(guard) if guard is not None else None
        self._f = None  # persistent append handle
        self._next_seq = None  # lazily established from the file
        self._base_tells = 0
        self._n_tells = 0  # tells appended since the last header
        #: fsync barriers this WAL has issued (append sync, group-commit
        #: barrier, header publish, compaction, torn-tail truncation) --
        #: the numerator of fsyncs per tell
        self.fsyncs = 0
        self._unbarriered = False  # flush-only records since the last fsync

    # -- scanning ----------------------------------------------------------
    def exists(self):
        return _common.with_retries(
            lambda: self.fs.exists(self.path), label="wal exists"
        )

    def scan(self):
        """Parse the log: ``(header, records, good_bytes, torn_bytes)``.

        ``records`` excludes the header; ``torn_bytes`` > 0 means the
        tail is torn (crash mid-append) and :meth:`recover` will
        truncate it.  A checksum failure before the final line is
        mid-file corruption and raises :class:`CheckpointError`.
        """
        if not self.exists():
            return None, [], 0, 0

        def _read():
            with self.fs.open(self.path, "rb") as f:
                return f.read()

        raw = _common.with_retries(_read, label="wal scan")
        # split at the byte level: records are ascii json (ensure_ascii),
        # so any undecodable line is torn garbage, and byte offsets --
        # what truncation needs -- stay exact
        lines = raw.splitlines(keepends=True)
        header, records, good = None, [], 0
        seen_seqs = set()
        for i, bline in enumerate(lines):
            try:
                line = bline.decode("utf-8")
            except UnicodeDecodeError:
                line = ""  # undecodable: treated as torn below
            body = _decode_line(line)
            if body is None:
                if i != len(lines) - 1:
                    raise CheckpointError(
                        f"WAL {self.path!r}: corrupt record at line "
                        f"{i + 1} is not the final line -- this is not "
                        "a torn tail; quarantine the file and restart the run"
                    )
                break
            if body.get("seq") == -1:
                if header is None:
                    header = body
                    if (
                        self.guard is not None
                        and body.get("guard") is not None
                        and list(body["guard"]) != list(self.guard)
                    ):
                        raise CheckpointError(
                            f"WAL {self.path!r} was written by a "
                            f"different study (guard {body.get('guard')!r}"
                            f" != {self.guard!r}); refusing to replay"
                        )
            elif body["seq"] not in seen_seqs:
                # a retried append whose first attempt landed despite
                # its fsync error writes the same (seq, payload) twice;
                # one logical record, counted and replayed once
                seen_seqs.add(body["seq"])
                records.append(body)
            good += len(bline)
        return header, records, good, len(raw) - good

    def recover(self):
        """Truncate a torn tail (atomic rewrite); returns bytes dropped."""
        header, records, good, torn = self.scan()
        if torn:
            def _truncate():
                with self.fs.open(self.path, "rb") as f:
                    raw = f.read()
                tmp = f"{self.path}.tmp.{os.getpid()}"
                with self.fs.open(tmp, "wb") as f:
                    f.write(raw[:good])
                    self.fs.fsync(f)
                    self.fsyncs += 1
                self.fs.rename(tmp, self.path)

            _common.with_retries(_truncate, label="wal truncate")
            logger.warning(
                "WAL %s: truncated %d torn tail byte(s)", self.path, torn
            )
        self._load_counters(header, records)
        return torn

    def replay(self):
        """Valid records after torn-tail recovery (establishes counters)."""
        self.recover()
        _header, records, _good, _torn = self.scan()
        return records

    def _load_counters(self, header, records):
        base = int(header.get("base_seq", 0)) if header else 0
        self._base_tells = int(header.get("base_tells", 0)) if header else 0
        self._next_seq = max(
            [base] + [int(r["seq"]) + 1 for r in records]
        )
        self._n_tells = sum(1 for r in records if r.get("kind") == "tell")

    # -- appending ---------------------------------------------------------
    def _header_body(self, base_seq, base_tells):
        return {
            "seq": -1,
            "magic": WAL_MAGIC,
            "guard": self.guard,
            "base_seq": int(base_seq),
            "base_tells": int(base_tells),
        }

    def _ensure_open(self):
        if self._f is not None:
            return
        if self._next_seq is None:
            if self.exists():
                self.recover()
            else:
                self._next_seq = 0
                self._n_tells = 0
                self._base_tells = 0
        if not self.exists():
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with self.fs.open(tmp, "w") as f:
                f.write(_encode_record(self._header_body(self._next_seq, 0)))
                self.fs.fsync(f)
                self.fsyncs += 1
            self.fs.rename(tmp, self.path)
        self._f = self.fs.open(self.path, "a")

    def append(self, kind, payload, sync=True):
        """Durably append one record; returns its sequence number.

        With ``sync=True`` (the default -- every tell) the record is on
        disk (written + fsynced) before this returns: the caller may
        apply the corresponding in-memory mutation only after -- that
        ordering IS the write-ahead contract.

        ``sync=False`` writes + flushes without the fsync barrier: the
        record is kernel-visible immediately (it survives process
        death; only a machine crash can tear it, which the torn-tail
        rule absorbs) and the NEXT synced append's fsync makes it
        durable.  Ask records ride this: a lost ask is re-derived
        bitwise from the restored rstate cursor, so asks need ordering,
        not their own disk barrier -- halving the per-trial fsync cost.

        Transient fs faults (the ESTALE/EIO class) retry through
        :func:`~hyperopt_tpu_torch.distributed._common.with_retries`; a
        failed attempt's torn partial record is truncated away before
        the retry, so a mount blip can never manufacture the mid-file
        corruption the scanner refuses.
        """
        _common.with_retries(self._ensure_open, label="wal open")
        seq = self._next_seq
        body = dict(payload)
        body["seq"] = seq
        body["kind"] = kind
        line = _encode_record(body)

        healed = [False]

        def attempt():
            try:
                self._ensure_open()
                self._f.write(line)
                if sync:
                    self.fs.fsync(self._f)
                    self.fsyncs += 1
                    self._unbarriered = False
                else:
                    self._f.flush()
                    self._unbarriered = True
            except OSError:
                # drop the handle and any torn partial record so the
                # retry appends onto a valid prefix
                self.close()
                try:
                    self.recover()
                    healed[0] = True
                except OSError:
                    pass
                raise

        _common.with_retries(attempt, label="wal append")
        if healed[0]:
            # a failed attempt may have landed its record anyway (fsync
            # error after a durable write): reload the counters from
            # the file truth (scan deduplicates by seq) instead of
            # double-counting in memory
            self.close()
            self.recover()
        else:
            self._next_seq = seq + 1
            if kind == "tell":
                self._n_tells += 1
        return seq

    def barrier(self):
        """Group-commit barrier: one fsync covering every flush-only
        record appended since the last fsync.  Returns True iff a sync
        was actually issued (no-op when nothing is unbarriered -- safe
        to call after :meth:`reset` absorbed the records, or twice).

        This is the other half of the ``sync=False`` idiom documented
        on :meth:`append`: a scheduler round flushes all of its tells
        per study, then one barrier per touched WAL establishes the
        same durability point N per-tell fsyncs would have.  A machine
        crash inside the flush-to-barrier window tears at most the
        unbarriered suffix, which the torn-tail rule truncates on
        replay; a process kill in the window loses nothing (flushed
        records are kernel-visible).
        """
        if not self._unbarriered:
            return False

        def attempt():
            try:
                self._ensure_open()
                self.fs.fsync(self._f)
            except OSError:
                # same healing discipline as append: drop the handle so
                # the retry fsyncs a freshly opened descriptor
                self.close()
                raise

        _common.with_retries(attempt, label="wal barrier")
        self.fsyncs += 1
        self._unbarriered = False
        return True

    def close(self):
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None

    @property
    def next_seq(self):
        if self._next_seq is None:
            self.recover()
        return self._next_seq

    @property
    def total_tells(self):
        """Tells ever logged, across compactions (the zero-lost /
        zero-duplicate counter the crash tests check against the
        trials count)."""
        if self._next_seq is None:
            self.recover()
        return self._base_tells + self._n_tells

    # -- compaction --------------------------------------------------------
    def reset(self):
        """Compact: atomically rewrite the log as header-only, carrying
        the monotone counters forward.  Called after a checkpoint
        bundle has absorbed every record; a crash before the rename
        leaves the old log, whose records replay idempotently (tells
        are deduplicated by tid at apply time)."""
        if self._next_seq is None:
            if self.exists():
                self.recover()
            else:
                self._next_seq = 0
        self.close()
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with self.fs.open(tmp, "w") as f:
            f.write(_encode_record(
                self._header_body(self._next_seq, self.total_tells)
            ))
            self.fs.fsync(f)
            self.fsyncs += 1
        self.fs.rename(tmp, self.path)
        self._base_tells = self.total_tells
        self._n_tells = 0
        # every pre-compaction record is in the bundle; nothing left to
        # barrier
        self._unbarriered = False
