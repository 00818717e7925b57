"""graftlint for the port: AST-based invariant checks over this
package's own code, in the reference checker's rule IDs and pragma
syntax.

The port has durable WALs and claim files, a socket protocol and a
threaded scheduler; these packs hold them to the same contracts the
reference package holds its own:

* GL0xx -- engine/meta (unknown pragma ID, unparsable file)
* GL1xx -- capture discipline: no host read, print or loop-variable
  closure inside a step a CUDA graph captures, no capture or
  ``build_*_fn`` inside a loop
* GL2xx -- dispatch hygiene: no read of a graph's static output after a
  later replay, no ``synchronize`` outside bench/profiling code, no
  build-then-call in one expression
* GL3xx -- crash consistency & fault routing: fsync before rename,
  typed excepts in the fault domain, no hand-rolled retry sleeps, no
  global RNG, durable state dumps, bounded service lists, metrics on
  the registry, one fsync per batch, deadlines on every socket op
* GL4xx -- graftir: program contracts over the registered programs'
  traced aten graphs (:mod:`.ir`, ``hyperopt-tpu-torch-lint --ir``),
  pinned in ``analysis/program_contracts.json``
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
usage/internal error).  The AST packs have no third-party dependencies
-- stdlib ``ast`` and ``tokenize`` only -- and never import ``torch``;
:mod:`.ir` (the ``--ir`` pack) imports it when it runs.
"""

from .baseline import load_baseline, write_baseline
from .engine import Finding, LintResult, lint_paths, lint_source
from .report import (
    format_ir_json,
    format_ir_text,
    format_json,
    format_text,
    format_wire_json,
    format_wire_text,
)
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
    "format_ir_text",
    "format_ir_json",
    "format_wire_text",
    "format_wire_json",
]
