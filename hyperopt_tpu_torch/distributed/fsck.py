"""Recovery audit of the PyTorch port's durable artifacts:
``hyperopt-tpu-torch-fsck`` (``python -m hyperopt_tpu_torch.distributed.fsck``).

The counterpart of :mod:`hyperopt_tpu.distributed.fsck`, with the same
issue kinds, repairs and exit codes, and ``--format json`` for a
machine-readable report (``{"target", "issues": [{"kind", "path",
"detail"}], "repaired", "remaining"}``).  Four targets, exactly one per
run:

``--serve ROOT`` audits a serve study root: the shared directory where
a fleet of ``SuggestService`` replicas (or one ``root=`` service, or the
engine-routed ``fmin``'s ``trials_save_file``) keeps one ``<name>.wal`` /
``<name>.snap`` / ``<name>.claim`` family per study:

=========================  ===========================================  =========================
issue                      how it happens                               repair
=========================  ===========================================  =========================
wal_torn_tail              a replica died mid-append                    truncate to valid prefix
wal_corrupt                a mid-file checksum failure                  quarantine the log
ckpt_fingerprint_mismatch  a foreign or unreadable bundle               quarantine the bundle
orphaned_snapshot_tmp      a crash between a tmp write and its rename   unlink
claim_orphaned             a claim with no WAL or snapshot              unlink
claim_stale_foreign        a live claim of an owner not --live-owner    tombstone, epoch bumped
study_half_migrated        a handoff tombstone no owner adopted         tombstone without mark
wal_snap_divergent         the bundle counts more tells than the WAL    quarantine the WAL
=========================  ===========================================  =========================

After ``--serve ROOT --repair`` every surviving family restores through
``SuggestService(root=ROOT).create_study(name)``.

``--driver PATH`` audits a solo driver's checkpoint family (``PATH``,
``PATH.meta``, ``PATH.wal``: ``fmin(trials_save_file=)`` without the
engine, :class:`~hyperopt_tpu_torch.utils.checkpoint.DriverRecovery`) for
the first four kinds above; after ``--repair`` ``fmin(resume_from=PATH)``
resumes.  ``--obs PATH`` audits a flight-recorder log (a torn tail is
truncated).  ``--dir D`` audits a file job-queue directory (``new/``,
``running/``, ``done/``: ``stale_tmp``, ``half_written``,
``orphaned_claim``, ``completed_claim``, ``duplicate_tid``), the
directory :mod:`.filequeue` and :mod:`.worker` keep.

The tool moves or deletes only what the protocol proves is residue;
anything ambiguous is quarantined (a ``.quarantined.<pid>`` suffix),
never destroyed.  Exit codes: 0 clean (or fully repaired), 1 issues
found (audit only) or issues left after a repair.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from . import _common
from .faults import REAL_FS
from .filequeue import _read_json

logger = logging.getLogger(__name__)

__all__ = [
    "Issue", "audit", "repair", "audit_driver", "repair_driver",
    "audit_serve", "repair_serve", "audit_obs", "repair_obs", "issue_doc",
    "main",
]

_SUBS = ("new", "running", "done")


class Issue:
    """One detected problem: ``kind`` (table above), the offending
    ``path``, and a human-readable ``detail``."""

    def __init__(self, kind, path, detail=""):
        self.kind = kind
        self.path = path
        self.detail = detail

    def __repr__(self):
        return f"Issue({self.kind}, {self.path!r}, {self.detail!r})"

    def __eq__(self, other):
        return (
            isinstance(other, Issue)
            and (self.kind, self.path) == (other.kind, other.path)
        )

    def __hash__(self):
        return hash((self.kind, self.path))


def _valid_doc(path, fs):
    try:
        doc = _common.with_retries(
            lambda: _read_json(path, fs=fs), label="fsck read"
        )
        return doc if isinstance(doc, dict) else None
    except (OSError, json.JSONDecodeError, ValueError):
        return None


def audit(root, fs=REAL_FS, reserve_timeout=None, tmp_grace=60.0):
    """Scan a queue directory and return the list of :class:`Issue`.

    ``reserve_timeout`` enables orphaned-claim detection (claims in
    running/ older than it); None skips that check (a live worker's
    claim is indistinguishable from an orphan without an age bound).
    ``tmp_grace`` is how old a ``*.tmp.*`` file must be before it
    counts as stale -- in-flight writers keep theirs younger.
    """
    root = os.path.abspath(root)
    issues = []
    now = time.time()
    docs = {}  # sub -> {name: doc or None}
    for sub in _SUBS + ("attachments",):
        subdir = os.path.join(root, sub)
        try:
            names = fs.listdir(subdir)
        except FileNotFoundError:
            continue
        for name in sorted(names):
            path = os.path.join(subdir, name)
            if ".tmp." in name:
                try:
                    age = now - fs.getmtime(path)
                except OSError:
                    continue
                if age >= tmp_grace:
                    issues.append(Issue(
                        "stale_tmp", path, f"age {age:.0f}s"
                    ))
                continue
            if sub == "attachments" or not name.endswith(".json"):
                continue
            doc = _valid_doc(path, fs)
            docs.setdefault(sub, {})[name] = doc
            if doc is None:
                issues.append(Issue(
                    "half_written", path, "unparseable job doc"
                ))
    # duplicate tids: the same job file present in more than one state
    # directory (a completed job recycled into new/ or running/, or a
    # claim that was both recycled and re-claimed)
    for name in sorted(
        set(docs.get("new", {})) | set(docs.get("running", {}))
    ):
        in_done = docs.get("done", {}).get(name) is not None
        in_new = name in docs.get("new", {})
        in_running = name in docs.get("running", {})
        if in_done:
            for sub in ("new", "running"):
                if name in docs.get(sub, {}):
                    kind = (
                        "completed_claim" if sub == "running"
                        else "duplicate_tid"
                    )
                    issues.append(Issue(
                        kind, os.path.join(root, sub, name),
                        "DONE doc already published",
                    ))
        elif in_new and in_running:
            issues.append(Issue(
                "duplicate_tid", os.path.join(root, "new", name),
                "also claimed in running/",
            ))
    # orphaned claims: running/ entries older than the reserve timeout
    # with no DONE doc (those are completed_claim above)
    if reserve_timeout is not None:
        for name, doc in sorted(docs.get("running", {}).items()):
            if doc is None or docs.get("done", {}).get(name) is not None:
                continue
            path = os.path.join(root, "running", name)
            try:
                age = now - fs.getmtime(path)
            except OSError:
                continue
            if age >= reserve_timeout:
                issues.append(Issue(
                    "orphaned_claim", path, f"age {age:.0f}s"
                ))
    return issues


def repair(root, issues, fs=REAL_FS):  # graftlint: disable=GL605 fsck IS the post-crash repair path: every rename here is idempotent and the chaos suites re-run fsck after injected kills, so a crash mid-repair is just another crash fsck heals
    """Fix every repairable :class:`Issue`; returns the repaired count.

    Order matters: shadowed duplicates are retired before orphaned
    claims are recycled, so a completed job can never be resurrected
    through the reap transition."""
    root = os.path.abspath(root)
    quarantine = os.path.join(root, "quarantine")
    repaired = 0
    order = {
        "stale_tmp": 0, "half_written": 1, "completed_claim": 2,
        "duplicate_tid": 3, "orphaned_claim": 4,
    }
    for issue in sorted(issues, key=lambda i: (order.get(i.kind, 9), i.path)):
        try:
            if issue.kind == "stale_tmp":
                fs.unlink(issue.path)
            elif issue.kind == "half_written":
                fs.makedirs(quarantine, exist_ok=True)
                dst = os.path.join(
                    quarantine,
                    f"{os.path.basename(os.path.dirname(issue.path))}."
                    f"{os.path.basename(issue.path)}",
                )
                fs.rename(issue.path, dst)
                logger.warning("quarantined %s -> %s", issue.path, dst)
            elif issue.kind in ("completed_claim", "duplicate_tid"):
                # DONE already published, or the job is claimed in
                # running/: this copy is the resurrection hazard
                fs.unlink(issue.path)
            elif issue.kind == "orphaned_claim":
                # the reap transition: refresh the mtime first so the
                # recycled job does not reappear in new/ reap-stale
                name = os.path.basename(issue.path)
                fs.utime(issue.path)
                fs.rename(issue.path, os.path.join(root, "new", name))
            else:
                continue
            repaired += 1
        except FileNotFoundError:
            repaired += 1  # a live worker fixed it first
        except OSError as e:
            logger.error("could not repair %r: %s", issue, e)
    return repaired


# ---------------------------------------------------------------------------
# serve study root (a fleet's shared WAL/snapshot/claim families)
# ---------------------------------------------------------------------------


def audit_serve(root, fs=REAL_FS, tmp_grace=60.0, claim_grace=None,
                live_owners=None):
    """Audit a serve study root: one ``<name>.wal`` / ``<name>.snap``
    / ``<name>.claim`` family per study, every crash mode a killed or
    failed-over replica can leave.  Returns the list of
    :class:`Issue` (kinds shared with :func:`audit_driver`, plus
    ``claim_orphaned`` and the cross-host kinds below).

    Cross-host checks: a shared NFS-style root is written
    by replicas on MANY hosts, so fsck must also catch the residue one
    host's crash leaves for another to trip over:

    * ``claim_stale_foreign`` -- a LIVE claim held by an owner not in
      ``live_owners`` (the operator-supplied set of replica ids that
      are actually up).  Only checked when ``live_owners`` is given;
      ``claim_grace`` (seconds) additionally requires the claim file
      to be at least that old before it counts, absorbing another
      host's skewed clock mid-handoff.  Repair tombstones the claim
      with a monotone epoch bump so any survivor can adopt without
      ``takeover``.
    * ``study_half_migrated`` -- a handoff-marked tombstone whose
      study was never adopted (the source released mid-migration and
      the coordinator died before the target restored).  The
      artifacts restore in place; repair clears the marker.
    * ``wal_snap_divergent`` -- the snapshot bundle counts more tells
      than the WAL has ever logged (``base_tells`` + records): the
      log was replaced or rolled back relative to the bundle by a
      host that had not seen its history.  Repair quarantines the
      WAL; the bundle holds the superset.
    """
    import pickle

    from ..exceptions import CheckpointError
    from ..utils.wal import TellWAL

    root = os.path.abspath(root)
    issues = []
    now = time.time()
    try:
        names = sorted(fs.listdir(root))
    except FileNotFoundError:
        return issues
    families = {}
    for name in names:
        full = os.path.join(root, name)
        if ".tmp." in name:
            try:
                age = now - fs.getmtime(full)
            except OSError:
                continue
            if age >= tmp_grace:
                issues.append(Issue(
                    "orphaned_snapshot_tmp", full, f"age {age:.0f}s"
                ))
            continue
        for suffix in (".wal", ".snap", ".claim"):
            if name.endswith(suffix):
                families.setdefault(
                    name[: -len(suffix)], set()
                ).add(suffix)
    for fam in sorted(families):
        kinds = families[fam]
        base = os.path.join(root, fam)
        wal_guard = None
        wal_total = None
        if ".wal" in kinds:
            wal = TellWAL(base + ".wal", fs=fs)
            try:
                header, records, _good, torn = wal.scan()
                wal_guard = (header or {}).get("guard")
                wal_total = (
                    int((header or {}).get("base_tells", 0))
                    + sum(1 for r in records if r.get("kind") == "tell")
                )
                if torn:
                    issues.append(Issue(
                        "wal_torn_tail", wal.path, f"{torn} torn byte(s)"
                    ))
            except CheckpointError as e:
                issues.append(Issue("wal_corrupt", wal.path, str(e)))
        if ".snap" in kinds:
            snap = base + ".snap"
            snap_guard = None
            snap_total = None
            try:
                with fs.open(snap, "rb") as f:
                    bundle = pickle.loads(f.read())
                snap_guard = bundle.get("guard")
                if bundle.get("total_tells") is not None:
                    snap_total = int(bundle["total_tells"])
            except Exception:  # graftlint: disable=GL302 an unreadable bundle is reported as an issue, not retried
                issues.append(Issue(
                    "ckpt_fingerprint_mismatch", snap, "bundle unreadable"
                ))
            if (
                snap_guard is not None
                and wal_guard is not None
                and list(snap_guard) != list(wal_guard)
            ):
                issues.append(Issue(
                    "ckpt_fingerprint_mismatch", snap,
                    f"bundle guard {snap_guard!r} != WAL guard "
                    f"{wal_guard!r}",
                ))
            elif (
                snap_total is not None
                and wal_total is not None
                and snap_total > wal_total
            ):
                issues.append(Issue(
                    "wal_snap_divergent", base + ".wal",
                    f"snapshot counts {snap_total} tell(s) but the WAL "
                    f"has only ever logged {wal_total} -- the log was "
                    "replaced or rolled back relative to the bundle",
                ))
        if kinds == {".claim"}:
            issues.append(Issue(
                "claim_orphaned", base + ".claim",
                "claim token with no WAL or snapshot",
            ))
            continue
        if ".claim" in kinds:
            doc = _valid_doc(base + ".claim", fs)
            if (
                doc is not None
                and not doc.get("released")
                and live_owners is not None
                and doc.get("replica") not in set(live_owners)
            ):
                try:
                    age = now - fs.getmtime(base + ".claim")
                except OSError:
                    age = None
                if claim_grace is None or age is None or age >= claim_grace:
                    issues.append(Issue(
                        "claim_stale_foreign", base + ".claim",
                        f"held by {doc.get('replica')!r} (epoch "
                        f"{doc.get('epoch')}), not in the live owner set",
                    ))
            if (
                doc is not None
                and doc.get("released")
                and doc.get("handoff")
            ):
                issues.append(Issue(
                    "study_half_migrated", base + ".claim",
                    f"handoff tombstone (epoch {doc.get('epoch')}) "
                    "never adopted: the source released, no owner "
                    "restored",
                ))
    return issues


def _republish_tombstone(path, fs):  # graftlint: disable=GL605 fsck repair primitive: the tombstone publish is idempotent (monotone epoch bump), and a crash between fsync and rename leaves the old claim visible for the NEXT fsck pass to tombstone again
    """Overwrite a claim file with a released tombstone, epoch bumped
    past whatever is on disk (the fsck repair for stale foreign claims
    and unacknowledged handoffs): monotone for every observer, and any
    survivor can then adopt the study without ``takeover``."""
    doc = _valid_doc(path, fs) or {}
    body = {
        "replica": None, "token": None,
        "epoch": int(doc.get("epoch", -1)) + 1, "released": True,
    }
    tmp = f"{path}.tmp.{os.getpid()}"
    with fs.open(tmp, "w") as f:
        f.write(json.dumps(body, sort_keys=True))
        fs.fsync(f)
    fs.rename(tmp, path)


def repair_serve(root, issues, fs=REAL_FS):  # graftlint: disable=GL605 fsck IS the post-crash repair path: tombstones and quarantine renames are idempotent, and chaos suites re-run fsck after injected kills
    """Fix every repairable serve-root :class:`Issue`; returns the
    repaired count.  Family kinds delegate to :func:`repair_driver`
    (truncate / quarantine / unlink are path-local); orphaned claims
    are unlinked -- nothing references them.  Cross-host kinds: stale
    foreign claims and half-migrated handoffs are tombstoned with a
    monotone epoch bump (never unlinked -- the epoch history is the
    fence); a divergent WAL is quarantined, its bundle holds the
    superset history."""
    repaired = 0
    rest = []
    for issue in issues:
        try:
            if issue.kind == "claim_orphaned":
                fs.unlink(issue.path)
            elif issue.kind in ("claim_stale_foreign",
                                "study_half_migrated"):
                _republish_tombstone(issue.path, fs)
            elif issue.kind == "wal_snap_divergent":
                dst = f"{issue.path}.quarantined.{os.getpid()}"
                fs.rename(issue.path, dst)
                logger.warning("quarantined %s -> %s", issue.path, dst)
            else:
                rest.append(issue)
                continue
            repaired += 1
        except FileNotFoundError:
            repaired += 1
        except OSError as e:
            logger.error("could not repair %r: %s", issue, e)
    return repaired + repair_driver(root, rest, fs=fs)


# ---------------------------------------------------------------------------
# driver checkpoint family (fmin's WAL + bundle artifacts)
# ---------------------------------------------------------------------------


def audit_driver(path, fs=REAL_FS, tmp_grace=60.0):
    """Audit a driver checkpoint family (``path`` / ``path.meta`` /
    ``path.wal``) for the corruption classes a killed driver can leave:
    a torn WAL tail, mid-file WAL corruption, a bundle whose guard
    fingerprint disagrees with the WAL header (a foreign study's
    artifact under this name), and orphaned ``*.tmp.*`` snapshots."""
    import pickle

    from ..exceptions import CheckpointError
    from ..utils.wal import TellWAL

    path = os.path.abspath(path)
    issues = []
    now = time.time()
    # orphaned snapshot tmp files: <family member>.tmp.<pid> residue of
    # a crash inside a durable publish (the rename never happened)
    dirname, base = os.path.split(path)
    try:
        names = fs.listdir(dirname)
    except FileNotFoundError:
        names = []
    for name in sorted(names):
        if not name.startswith(base) or ".tmp." not in name:
            continue
        full = os.path.join(dirname, name)
        try:
            age = now - fs.getmtime(full)
        except OSError:
            continue
        if age >= tmp_grace:
            issues.append(Issue(
                "orphaned_snapshot_tmp", full, f"age {age:.0f}s"
            ))
    # WAL integrity: a torn tail is normal crash residue (repairable by
    # truncation); a mid-file checksum failure is not ours to truncate.
    # Under group commit the window widens: a machine crash
    # between a round's flushes and its barrier fsync can tear (or drop)
    # the whole unbarriered suffix, not just one record -- the same
    # truncate-to-valid-prefix repair covers it, and the barriered
    # prefix is exactly what replay restores
    wal = TellWAL(path + ".wal", fs=fs)
    wal_guard = None
    if wal.exists():
        try:
            header, _records, _good, torn = wal.scan()
            wal_guard = (header or {}).get("guard")
            if torn:
                issues.append(Issue(
                    "wal_torn_tail", wal.path, f"{torn} torn byte(s)"
                ))
        except CheckpointError as e:
            issues.append(Issue("wal_corrupt", wal.path, str(e)))
    # bundle fingerprint: the meta guard and the WAL header guard were
    # stamped by the same study -- disagreement means one of them is a
    # foreign artifact parked under this family's name
    meta_path = path + ".meta"
    if fs.exists(meta_path) and wal_guard is not None:
        try:
            with fs.open(meta_path, "rb") as f:
                meta = pickle.loads(f.read())
            meta_guard = meta.get("guard")
        except Exception:  # graftlint: disable=GL302 an unreadable bundle is reported as an issue, not retried
            meta_guard = None
            issues.append(Issue(
                "ckpt_fingerprint_mismatch", meta_path,
                "bundle unreadable",
            ))
        if meta_guard is not None and list(meta_guard) != list(wal_guard):
            issues.append(Issue(
                "ckpt_fingerprint_mismatch", meta_path,
                f"bundle guard {meta_guard!r} != WAL guard {wal_guard!r}",
            ))
    return issues


def repair_driver(path, issues, fs=REAL_FS):  # graftlint: disable=GL605 fsck IS the post-crash repair path: quarantine renames are idempotent and re-runnable, so a crash mid-repair is just another crash the next fsck pass heals
    """Fix every repairable driver-family :class:`Issue`; returns the
    repaired count.  Quarantined artifacts get a ``.quarantined.<pid>``
    suffix next to the family -- resume then falls back to the
    surviving artifacts (trials pickle + valid WAL prefix)."""
    from ..utils.wal import TellWAL

    repaired = 0
    for issue in sorted(issues, key=lambda i: (i.kind, i.path)):
        try:
            if issue.kind == "orphaned_snapshot_tmp":
                fs.unlink(issue.path)
            elif issue.kind == "wal_torn_tail":
                TellWAL(issue.path, fs=fs).recover()
            elif issue.kind in ("wal_corrupt", "ckpt_fingerprint_mismatch"):
                dst = f"{issue.path}.quarantined.{os.getpid()}"
                fs.rename(issue.path, dst)
                logger.warning("quarantined %s -> %s", issue.path, dst)
            else:
                continue
            repaired += 1
        except FileNotFoundError:
            repaired += 1  # a live driver fixed it first
        except OSError as e:
            logger.error("could not repair %r: %s", issue, e)
    return repaired


def audit_obs(path, fs=REAL_FS):
    """Audit a flight-recorder log (``--obs PATH``): a torn
    tail (crash mid-export) is repairable by truncation; mid-file
    corruption is reported but left in place -- the span scanner
    already skips it, and telemetry never warrants quarantine."""
    from ..obs.flightrec import audit_flight_log

    return [
        Issue(kind, p, detail)
        for kind, p, detail in audit_flight_log(path, fs=fs)
    ]


def repair_obs(path, issues, fs=REAL_FS):
    """Truncate a flight log's torn tail (tmp + fsync + rename);
    returns the repaired count."""
    from ..obs.flightrec import repair_flight_log

    repaired = 0
    for issue in issues:
        if issue.kind != "obs_torn_tail":
            continue
        dropped = repair_flight_log(issue.path, fs=fs)
        if dropped:
            logger.info(
                "flight log %s: truncated %d torn byte(s)",
                issue.path, dropped,
            )
            repaired += 1
    return repaired


def issue_doc(issue):
    """One :class:`Issue` as a plain dict (the ``--format json`` report's
    rows)."""
    return {"kind": issue.kind, "path": issue.path, "detail": issue.detail}


def main(argv=None):
    """``hyperopt-tpu-torch-fsck``: audit, and with ``--repair`` fix, one
    target; returns the exit code."""
    parser = argparse.ArgumentParser(
        prog="hyperopt-tpu-torch-fsck",
        description="Audit (and repair) a serve study root (--serve), a driver checkpoint "
        "family (--driver), a flight-recorder log (--obs) or a file job-queue directory "
        "(--dir).",
    )
    parser.add_argument("--dir", help="queue directory")
    parser.add_argument("--driver", metavar="PATH",
                        help="audit fmin's driver checkpoint family (PATH, PATH.meta, "
                        "PATH.wal) instead of a queue directory")
    parser.add_argument("--serve", metavar="ROOT",
                        help="audit a serve study root (a fleet's shared directory of "
                        "per-study <name>.wal/.snap/.claim families) instead")
    parser.add_argument("--obs", metavar="PATH",
                        help="audit a flight-recorder span log (torn export tails are "
                        "truncated under --repair) instead")
    parser.add_argument("--repair", action="store_true",
                        help="fix repairable issues instead of only reporting them")
    parser.add_argument("--reserve-timeout", type=float, default=120.0,
                        help="claim age that counts as orphaned (seconds); the worker "
                        "default.  Pass a negative value to skip orphan detection.")
    parser.add_argument("--tmp-grace", type=float, default=60.0,
                        help="tmp-file age that counts as stale (seconds)")
    parser.add_argument("--live-owner", action="append", metavar="RID",
                        help="(--serve) a replica id known to be up (repeatable); enables "
                        "the claim_stale_foreign check: a live claim held by any OTHER owner "
                        "is reported and, under --repair, tombstoned with its epoch bumped")
    parser.add_argument("--claim-grace", type=float, default=None,
                        help="(--serve) minimum claim-file age (seconds) before a foreign "
                        "claim counts as stale (absorbs another host's skewed clock); "
                        "default: no age requirement")
    parser.add_argument("--format", choices=("text", "json"), default="text",
                        help="json: one JSON object {target, issues, repaired, remaining} "
                        "on standard output")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    options = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if options.verbose else logging.INFO,
                        stream=sys.stderr)
    n_targets = sum(1 for t in (options.dir, options.driver, options.serve, options.obs) if t)
    if n_targets != 1:
        parser.error("exactly one of --dir, --driver, --serve or --obs is required")
    if options.obs:
        target = options.obs
        do_audit = lambda: audit_obs(options.obs)  # noqa: E731
        do_repair = lambda issues: repair_obs(options.obs, issues)  # noqa: E731
    elif options.serve:
        target = options.serve
        do_audit = lambda: audit_serve(  # noqa: E731
            options.serve, tmp_grace=options.tmp_grace, claim_grace=options.claim_grace,
            live_owners=options.live_owner)
        do_repair = lambda issues: repair_serve(options.serve, issues)  # noqa: E731
    elif options.driver:
        target = options.driver
        do_audit = lambda: audit_driver(options.driver, tmp_grace=options.tmp_grace)  # noqa: E731
        do_repair = lambda issues: repair_driver(options.driver, issues)  # noqa: E731
    else:
        target = options.dir
        reserve_timeout = None if options.reserve_timeout < 0 else options.reserve_timeout
        do_audit = lambda: audit(options.dir, reserve_timeout=reserve_timeout,  # noqa: E731
                                 tmp_grace=options.tmp_grace)
        do_repair = lambda issues: repair(options.dir, issues)  # noqa: E731
    issues = do_audit()
    repaired = remaining = None
    if issues and options.repair:
        repaired = do_repair(issues)
        remaining = do_audit()
    if options.format == "json":
        print(json.dumps({
            "target": target,
            "issues": [issue_doc(i) for i in issues],
            "repaired": repaired,
            "remaining": None if remaining is None else [issue_doc(i) for i in remaining],
        }, sort_keys=True))
    else:
        for issue in issues:
            print(f"{issue.kind}: {issue.path} ({issue.detail})")
        if not issues:
            print(f"{target}: clean")
        elif not options.repair:
            print(f"{len(issues)} issue(s) found (re-run with --repair to fix)")
        else:
            print(f"repaired {repaired}/{len(issues)} issue(s); {len(remaining)} remain")
    if not issues:
        return 0
    if not options.repair:
        return 1
    return 0 if not remaining else 1


if __name__ == "__main__":
    sys.exit(main())
