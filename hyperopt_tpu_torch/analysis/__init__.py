"""Static analysis of search spaces.

Reference parity: ``hyperopt_tpu/analysis/__init__.py:56-78``, with only
the space lint exported: :func:`lint_space` flags the malformed spaces
(duplicate labels, inverted bounds, non-positive q or sigma, float32
overflow of log-scale ranges, unreachable branches, int-cast truncation)
that would otherwise fail deep inside a suggest on the card.  It is
``fmin(..., validate_space=True)``'s pre-flight.  The reference's race,
durability, protocol and program passes wait for ROADMAP.md queue A
item 7.
"""

from __future__ import annotations

from .diagnostics import Diagnostic, Severity, format_report, has_errors
from .space_lint import lint_space

__all__ = [
    "Diagnostic",
    "Severity",
    "format_report",
    "has_errors",
    "lint_space",
]
