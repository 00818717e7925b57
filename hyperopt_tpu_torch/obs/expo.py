"""Prometheus-style text exposition of collected registry rows (a copy
of :mod:`hyperopt_tpu.obs.expo`: the renderer, and the label stamping and
merge a fleet-wide scrape uses): each row is a plain dict
with name/type/help/labels and either a scalar ``value`` or a
histogram's buckets/sum/count, as
:meth:`~hyperopt_tpu_torch.obs.registry.MetricsRegistry.collect` returns
them."""

from __future__ import annotations

import math

__all__ = ["merge_rows", "render_prometheus", "tag_rows"]


def _fmt_value(v):
    if v is None:
        return "NaN"
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape(s):
    return (
        str(s).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _label_str(labels, extra=None):
    items = dict(labels or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{_escape(v)}"' for k, v in sorted(items.items())
    )
    return "{" + body + "}"


def tag_rows(rows, **labels):
    """Stamp extra labels onto collected rows (the router tags each
    replica's rows with ``replica=<rid>`` before merging); a row that
    already carries a label keeps its own value."""
    out = []
    for row in rows:
        row = dict(row)
        row["labels"] = {**labels, **(row.get("labels") or {})}
        out.append(row)
    return out


def merge_rows(*row_lists):
    """Concatenate collected-row lists (label sets keep the series
    distinct; the exposition groups HELP/TYPE by name)."""
    out = []
    for rows in row_lists:
        out.extend(rows)
    return out


def render_prometheus(rows):
    """Collected rows -> Prometheus text exposition.  HELP/TYPE are
    emitted once per metric name (first row's help wins); histogram
    rows expand into cumulative ``_bucket``/``_sum``/``_count``."""
    seen = set()
    lines = []
    for row in rows:
        name = row["name"]
        if name not in seen:
            seen.add(name)
            if row.get("help"):
                lines.append(f"# HELP {name} {row['help']}")
            lines.append(f"# TYPE {name} {row.get('type', 'untyped')}")
        labels = row.get("labels") or {}
        if row.get("type") == "histogram":
            acc = 0
            for b in row["buckets"]:
                acc += b["count"]
                le = "+Inf" if math.isinf(b["le"]) else _fmt_value(b["le"])
                lines.append(
                    f"{name}_bucket{_label_str(labels, {'le': le})} {acc}"
                )
            lines.append(
                f"{name}_sum{_label_str(labels)} {_fmt_value(row['sum'])}"
            )
            lines.append(
                f"{name}_count{_label_str(labels)} {row['count']}"
            )
        else:
            lines.append(
                f"{name}{_label_str(labels)} {_fmt_value(row.get('value'))}"
            )
    return "\n".join(lines) + ("\n" if lines else "")
