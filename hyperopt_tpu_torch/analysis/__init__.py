"""graftlint for the port: AST-based invariant checks over this
package's own code, in the reference checker's rule IDs and pragma
syntax.

The port has durable WALs and claim files, a socket protocol and a
threaded scheduler; these packs hold them to the same contracts the
reference package holds its own:

* GL0xx -- engine/meta (unknown pragma ID, unparsable file)
* GL3xx -- crash consistency & fault routing: fsync before rename,
  typed excepts in the fault domain, no hand-rolled retry sleeps, no
  global RNG, durable state dumps, bounded service lists, metrics on
  the registry, one fsync per batch, deadlines on every socket op
* GL5xx -- graftrace: static lock-discipline & race analysis over the
  serve/distributed threaded surface (:mod:`.trace`,
  ``hyperopt-tpu-torch-lint --trace``), paired with a runtime lockdep
  sanitizer (:mod:`.lockdep`) the serve suites arm at test time
* GL6xx -- graftwire: wire-protocol & fault-surface contracts over the
  serve seams (:mod:`.wire`, ``hyperopt-tpu-torch-lint --wire``),
  pinned in ``analysis/wire_contracts.json``

Inline suppression::

    risky_line()  # graftlint: disable=GL303 supervisor backoff

on the violating line, or on the ``def``/``class`` header to cover the
whole scope.  Grandfathered findings live in a committed baseline
(``analysis/lint_baseline.json``, keyed by (path, rule, content-hash)),
held at zero entries.

CLI: ``hyperopt-tpu-torch-lint`` (exit 0 clean, 1 findings, 2
usage/internal error).  No third-party dependencies -- stdlib ``ast``
and ``tokenize`` only; nothing here imports ``torch``.
"""

from .baseline import load_baseline, write_baseline
from .engine import Finding, LintResult, lint_paths, lint_source
from .report import format_json, format_text, format_wire_json, format_wire_text
from .rules import RULES

__all__ = [
    "Finding",
    "LintResult",
    "lint_paths",
    "lint_source",
    "RULES",
    "load_baseline",
    "write_baseline",
    "format_text",
    "format_json",
    "format_wire_text",
    "format_wire_json",
]
