"""``hyperopt-tpu-torch-lint``: the port's graftlint console entry point.

Exit-code contract (the reference checker's, pinned by
tests/test_torch_analysis_cli.py):

* 0 -- clean (no findings after baseline + pragmas / contracts)
* 1 -- findings
* 2 -- usage error or internal failure (bad path, unreadable baseline
  or contracts manifest, engine exception); argparse's own usage errors
  also exit 2

With no path it lints the port's package, against the port's committed
baseline (``hyperopt_tpu_torch/analysis/lint_baseline.json``), with
finding paths anchored at the package's parent -- so the CLI reports
identical findings no matter where it is invoked from.  ``--root``
anchors them elsewhere; an explicit ``--baseline FILE`` anchors them at
the file's directory.

``--trace`` switches to the graftrace concurrency pack (GL5xx, see
:mod:`.trace`): lock-domain inference and lock-discipline checks over
the same path arguments, with the identical exit-code contract,
``--format json``, pragma, and baseline workflow as the default pack.

``--ir`` switches to the graftir program-contract pack (GL4xx, see
:mod:`.ir`): it traces the REGISTERED programs on the CPU, not the path
arguments, and diffs them against the committed
``hyperopt_tpu_torch/analysis/program_contracts.json``.  Accept
deliberate contract changes with ``--ir --update-contracts``.

``--wire`` switches to the graftwire wire-protocol pack (GL6xx, see
:mod:`.wire`): it checks the FIXED protocol surfaces (service/router
dispatch, client call sites, typed-error mapping, crash-point
registries), not the path arguments, against the committed
``hyperopt_tpu_torch/analysis/wire_contracts.json``.  Accept deliberate
reply-shape changes with ``--wire --update-contracts``.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import baseline as baseline_mod
from .engine import lint_paths
from .report import (
    format_ir_json,
    format_ir_text,
    format_json,
    format_text,
    format_wire_json,
    format_wire_text,
)
from .rules import RULES

__all__ = ["main"]

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)
DEFAULT_BASELINE = os.path.join(PACKAGE_DIR, "analysis", "lint_baseline.json")


def _build_parser():
    p = argparse.ArgumentParser(
        prog="hyperopt-tpu-torch-lint",
        description="AST-based invariant checker for the port's capture "
        "discipline and crash consistency (graftlint), program contracts "
        "over traced aten graphs (graftir, --ir), lock discipline "
        "(graftrace, --trace) and wire contracts (graftwire, --wire).",
    )
    p.add_argument(
        "paths", nargs="*", default=[PACKAGE_DIR],
        help="files or directories to lint (default: the "
        "hyperopt_tpu_torch package; ignored under --ir, which checks the "
        "registered programs, and --wire, which checks the fixed protocol "
        "surfaces)",
    )
    p.add_argument(
        "--format", choices=("text", "json"), default="text",
        help="report format (default: text)",
    )
    p.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="findings baseline to grandfather (default: the package's "
        "analysis/lint_baseline.json)",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline, report every finding",
    )
    p.add_argument(
        "--write-baseline", action="store_true",
        help="write the current findings to the baseline file and exit 0",
    )
    p.add_argument(
        "--root", default=None, metavar="DIR",
        help="anchor finding paths at this directory (default: the "
        "directory of an explicit --baseline, else the package's "
        "parent) -- makes reports identical regardless of invocation "
        "cwd",
    )
    p.add_argument(
        "--ir", action="store_true",
        help="run the graftir program-contract pack (GL4xx) over the "
        "registered programs, traced to aten graphs on the CPU",
    )
    p.add_argument(
        "--trace", action="store_true",
        help="run the graftrace concurrency pack (GL5xx: lock-domain "
        "inference, lock-order cycles, blocking/dispatch under lock) "
        "instead of the default AST pack; same exit contract, formats, "
        "and baseline workflow",
    )
    p.add_argument(
        "--wire", action="store_true",
        help="run the graftwire wire-protocol pack (GL6xx: op-surface "
        "symmetry, reply-contract drift, typed-error mapping, crash-"
        "point arming) over the protocol seams; same exit contract, "
        "formats, and baseline workflow",
    )
    p.add_argument(
        "--contracts", default=None, metavar="FILE",
        help="contracts manifest for --ir / --wire (default: the "
        "package's committed analysis/program_contracts.json / "
        "analysis/wire_contracts.json)",
    )
    p.add_argument(
        "--update-contracts", action="store_true",
        help="with --ir or --wire: re-pin the manifest to the current "
        "programs / reply shapes instead of diffing against it",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule pack and exit",
    )
    return p


def _baseline_and_root(args):
    """The baseline in play and the anchor of finding paths: the
    package's own baseline and parent unless the caller names others."""
    baseline_path = None if args.no_baseline else args.baseline
    if baseline_path is None and not args.no_baseline:
        if os.path.exists(DEFAULT_BASELINE):
            baseline_path = DEFAULT_BASELINE
    root = args.root
    if root is None:
        root = (
            os.path.dirname(os.path.abspath(args.baseline))
            if args.baseline is not None and not args.no_baseline
            else REPO_ROOT
        )
    return baseline_path, root


def _main_ir(args):
    from . import ir as ir_mod

    try:
        result = ir_mod.check_programs(
            contracts_path=args.contracts, update=args.update_contracts,
        )
    except (FileNotFoundError, ValueError, OSError) as e:
        print(f"hyperopt-tpu-torch-lint: error: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # internal failure is 2, never a traceback
        print(
            f"hyperopt-tpu-torch-lint: internal error: {type(e).__name__}: {e}",
            file=sys.stderr,
        )
        return 2
    if result.updated:
        print(
            f"pinned {result.programs_checked} program contract(s) to "
            f"{result.contracts_path}",
            file=sys.stderr,
        )
    print(
        format_ir_json(result) if args.format == "json"
        else format_ir_text(result)
    )
    return 0 if result.clean else 1


def _main_wire(args):
    from . import wire as wire_mod

    baseline_path, root = _baseline_and_root(args)

    try:
        counter = None
        if baseline_path is not None and not args.write_baseline:
            counter = baseline_mod.load_baseline(baseline_path)
        result = wire_mod.check_wire(
            contracts_path=args.contracts, update=args.update_contracts,
            root=root, baseline=counter,
        )
    except (FileNotFoundError, ValueError, OSError) as e:
        print(f"hyperopt-tpu-torch-lint: error: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # internal failure is 2, never a traceback
        print(
            f"hyperopt-tpu-torch-lint: internal error: {type(e).__name__}: {e}",
            file=sys.stderr,
        )
        return 2

    if args.write_baseline:
        out = baseline_path or DEFAULT_BASELINE
        baseline_mod.write_baseline(out, result.findings)
        print(
            f"wrote {len(result.findings)} finding(s) to {out}",
            file=sys.stderr,
        )
        return 0
    if result.updated:
        print(
            f"pinned {result.ops_checked} op reply contract(s) to "
            f"{result.contracts_path}",
            file=sys.stderr,
        )
    print(
        format_wire_json(result) if args.format == "json"
        else format_wire_text(result)
    )
    return 0 if result.clean else 1


def main(argv=None):
    parser = _build_parser()
    args = parser.parse_args(argv)

    if args.list_rules:
        for rid in sorted(RULES):
            r = RULES[rid]
            print(f"{r.id}  {r.name:28s} {r.summary}")
        return 0

    if args.update_contracts and not (args.ir or args.wire):
        print(
            "hyperopt-tpu-torch-lint: error: --update-contracts requires "
            "--ir or --wire",
            file=sys.stderr,
        )
        return 2
    packs = [f for f, on in (
        ("--ir", args.ir), ("--trace", args.trace), ("--wire", args.wire),
    ) if on]
    if len(packs) > 1:
        print(
            f"hyperopt-tpu-torch-lint: error: {' and '.join(packs)} are "
            "separate packs; run them as separate invocations",
            file=sys.stderr,
        )
        return 2
    if args.ir:
        return _main_ir(args)
    if args.wire:
        return _main_wire(args)

    baseline_path, root = _baseline_and_root(args)

    pack = "trace" if args.trace else "ast"
    try:
        counter = None
        if baseline_path is not None and not args.write_baseline:
            counter = baseline_mod.load_baseline(baseline_path)
        result = lint_paths(
            args.paths, baseline=counter, root=root, pack=pack
        )
    except (FileNotFoundError, ValueError, OSError) as e:
        print(f"hyperopt-tpu-torch-lint: error: {e}", file=sys.stderr)
        return 2
    except Exception as e:  # internal failure is 2, never a traceback
        print(
            f"hyperopt-tpu-torch-lint: internal error: {type(e).__name__}: {e}",
            file=sys.stderr,
        )
        return 2

    if args.write_baseline:
        out = baseline_path or DEFAULT_BASELINE
        baseline_mod.write_baseline(out, result.findings)
        print(
            f"wrote {len(result.findings)} finding(s) to {out}",
            file=sys.stderr,
        )
        return 0

    print(format_json(result) if args.format == "json" else format_text(result))
    return 0 if result.clean else 1


if __name__ == "__main__":
    sys.exit(main())
