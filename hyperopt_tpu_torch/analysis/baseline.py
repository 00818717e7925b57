"""Findings baseline: grandfathered findings, committed next to the code.

Entries are keyed by ``(path, rule, content-hash)`` where the hash
covers the rule ID plus the *stripped text of the violating line* --
NOT the line number -- so unrelated edits above a grandfathered finding
do not invalidate the baseline, while any edit to the violating line
itself surfaces the finding again (the edit is the moment to fix it).

The baseline is a multiset: two identical violating lines in one file
need two entries, and fixing one of them shrinks the count.  The goal
is a file that is small and shrinking; ``--write-baseline`` regenerates
it, and the tier-1 test pins its size so it cannot silently grow.
"""

from __future__ import annotations

import collections
import json

__all__ = ["load_baseline", "write_baseline", "apply_baseline", "to_entries"]

BASELINE_VERSION = 1


def to_entries(findings):
    """Serializable baseline entries for ``findings`` (sorted, stable)."""
    counter = collections.Counter(
        (f.path, f.rule, f.content_hash(), f.source_line.strip())
        for f in findings
    )
    return [
        {
            "path": path,
            "rule": rule,
            "content_hash": h,
            "line": text,       # for humans reviewing the baseline diff
            "count": n,
        }
        for (path, rule, h, text), n in sorted(counter.items())
    ]


def write_baseline(path, findings):
    payload = {
        "version": BASELINE_VERSION,
        "entries": to_entries(findings),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


def load_baseline(path):
    """Load a baseline into a Counter keyed by (path, rule, hash)."""
    with open(path, encoding="utf-8") as f:
        payload = json.load(f)
    if payload.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path!r} has version {payload.get('version')!r}; "
            f"this engine reads version {BASELINE_VERSION}"
        )
    counter = collections.Counter()
    for e in payload.get("entries", []):
        counter[(e["path"], e["rule"], e["content_hash"])] += int(
            e.get("count", 1)
        )
    return counter


def apply_baseline(findings, counter):
    """Filter findings through the baseline multiset; each entry absorbs
    up to ``count`` occurrences.  Returns (new_findings, n_matched)."""
    remaining = collections.Counter(counter)
    kept, matched = [], 0
    for f in findings:
        key = (f.path, f.rule, f.content_hash())
        if remaining.get(key, 0) > 0:
            remaining[key] -= 1
            matched += 1
        else:
            kept.append(f)
    return kept, matched
