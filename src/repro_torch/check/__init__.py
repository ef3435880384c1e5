"""Correctness passes over the DTR engine, copied from ``repro.check``:

* :mod:`.trace_lint` — static liveness / remat-closure / alias-pin analysis
  over ``core.graph.Log`` programs, run before every ``trace.replay``
  replay;
* :mod:`.sanitizer` — a shadow model cross-checking every runtime
  transition, enabled with ``DTRRuntime(..., sanitize=True)``.

The AST linter ``repro.check.lint`` checks the repository's own sources and
has no counterpart here.
"""
from .sanitizer import SanitizerViolation, ShadowSanitizer
from .trace_lint import (TraceIssue, TraceLintError, check_log, lint_log,
                         verify_log)

__all__ = [
    "SanitizerViolation", "ShadowSanitizer",
    "TraceIssue", "TraceLintError", "check_log", "lint_log", "verify_log",
]
