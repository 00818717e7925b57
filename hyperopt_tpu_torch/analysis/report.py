"""Reporters: the text form for humans at a terminal, JSON for tooling
(``--format json``; ``chip_smoke.py`` reads the summaries from it)."""

from __future__ import annotations

import json

from .rules import RULES

__all__ = [
    "format_text", "format_json", "result_summary",
    "ir_summary", "format_ir_text", "format_ir_json",
    "wire_summary", "format_wire_text", "format_wire_json",
]


def result_summary(result):
    return {
        "total": len(result.findings),
        "files": result.n_files,
        "pragma_suppressed": result.n_suppressed,
        "baseline_matched": result.n_baseline_matched,
        "baseline_size": result.baseline_size,
    }


def format_text(result):
    lines = []
    for f in result.findings:
        rule = RULES.get(f.rule)
        name = f" ({rule.name})" if rule else ""
        lines.append(f"{f.path}:{f.line}:{f.col + 1}: {f.rule}{name} {f.message}")
        if f.source_line.strip():
            lines.append(f"    {f.source_line.strip()}")
    s = result_summary(result)
    lines.append(
        f"graftlint: {s['total']} finding(s) in {s['files']} file(s) "
        f"({s['baseline_matched']} baselined, "
        f"{s['pragma_suppressed']} suppressed)"
    )
    return "\n".join(lines)


def format_json(result):
    return json.dumps(
        {
            "summary": result_summary(result),
            "findings": [f.to_dict() for f in result.findings],
        },
        indent=2,
        sort_keys=True,
    )


def ir_summary(result):
    """Summary block of an :class:`~.ir.IRResult`."""
    return {
        "total": len(result.findings),
        "programs_checked": result.programs_checked,
        "contract_drift": result.contract_drift,
        "contracts": result.contracts_path,
        "updated": result.updated,
    }


def format_ir_text(result):
    lines = []
    for f in result.findings:
        rule = RULES.get(f.rule)
        name = f" ({rule.name})" if rule else ""
        lines.append(f"{f.path}:{f.line}: {f.rule}{name} {f.message}")
    s = ir_summary(result)
    lines.append(
        f"graftir: {s['total']} finding(s) across "
        f"{s['programs_checked']} program(s), "
        f"{s['contract_drift']} with contract drift"
        + (" [contracts updated]" if result.updated else "")
    )
    return "\n".join(lines)


def format_ir_json(result):
    return json.dumps(
        {
            "summary": ir_summary(result),
            "findings": [f.to_dict() for f in result.findings],
        },
        indent=2,
        sort_keys=True,
    )


def wire_summary(result):
    """Summary block of a :class:`~.wire.WireResult`."""
    return {
        "total": len(result.findings),
        "ops_checked": result.ops_checked,
        "contract_drift": result.contract_drift,
        "crash_points_total": result.crash_points_total,
        "crash_points_armed": result.crash_points_armed,
        "errors_checked": result.errors_checked,
        "pragma_suppressed": result.n_suppressed,
        "baseline_matched": result.n_baseline_matched,
        "baseline_size": result.baseline_size,
        "contracts": result.contracts_path,
        "updated": result.updated,
    }


def format_wire_text(result):
    lines = []
    for f in result.findings:
        rule = RULES.get(f.rule)
        name = f" ({rule.name})" if rule else ""
        lines.append(f"{f.path}:{f.line}: {f.rule}{name} {f.message}")
    s = wire_summary(result)
    lines.append(
        f"graftwire: {s['total']} finding(s) across "
        f"{s['ops_checked']} op(s), "
        f"{s['contract_drift']} with contract drift, "
        f"{s['crash_points_armed']}/{s['crash_points_total']} crash "
        f"point(s) armed "
        f"({s['baseline_matched']} baselined, "
        f"{s['pragma_suppressed']} suppressed)"
        + (" [contracts updated]" if result.updated else "")
    )
    return "\n".join(lines)


def format_wire_json(result):
    return json.dumps(
        {
            "summary": wire_summary(result),
            "findings": [f.to_dict() for f in result.findings],
        },
        indent=2,
        sort_keys=True,
    )
