"""Structured diagnostics of the space lint.

Reference parity: ``hyperopt_tpu/analysis/diagnostics.py`` — the
``Diagnostic`` record (rule id, severity, location, message, fix hint),
the rule catalog, suppression by rule id, and the reporter — with the
catalog cut to the ``SP1xx`` space rules, the only pass ported so far.
The reference's program, race, durability and protocol passes (and the
``# lint: disable`` source comments they read) wait for ROADMAP.md
queue A item 7.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional


class Severity:
    """Ordered severity levels (compare with :func:`severity_rank`)."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"


_SEVERITY_ORDER = {Severity.ERROR: 0, Severity.WARNING: 1, Severity.INFO: 2}


def severity_rank(sev: str) -> int:
    return _SEVERITY_ORDER.get(sev, 99)


@dataclass(frozen=True)
class Rule:
    id: str
    severity: str
    title: str
    doc: str


RULES = {
    r.id: r
    for r in [
        Rule(
            "SP101", Severity.ERROR, "duplicate-label",
            "The same hyperparameter label names two distinct nodes "
            "(e.g. re-declared in sibling hp.choice branches).  The "
            "trials store keys observation history by label, so the two "
            "parameters would silently share one history.",
        ),
        Rule(
            "SP102", Severity.ERROR, "inverted-bounds",
            "A bounded distribution has low >= high; sampling is "
            "ill-defined and the device-side truncated-GMM draw "
            "degenerates to NaN.",
        ),
        Rule(
            "SP103", Severity.ERROR, "non-positive-q",
            "A quantized distribution has q <= 0; the round(x/q)*q "
            "lattice is undefined (division by zero on device).",
        ),
        Rule(
            "SP104", Severity.ERROR, "non-positive-sigma",
            "A normal-family distribution has sigma <= 0; the Parzen "
            "fit and the sampler both divide by sigma.",
        ),
        Rule(
            "SP105", Severity.ERROR, "f32-overflow-range",
            "A log-scale range is wide enough that exp(high) overflows "
            "float32 on device: observations and candidates become inf "
            "and every EI score NaNs out, trials after the fit engages.",
        ),
        Rule(
            "SP106", Severity.WARNING, "f32-underflow-range",
            "A log-scale low is below log(float32 tiny) ≈ -87.3: "
            "exp(low) underflows to 0 on device, and the fit-space "
            "log transform clamps the dead region to a single point.",
        ),
        Rule(
            "SP107", Severity.WARNING, "unreachable-branch",
            "A choice branch can never be selected (hp.pchoice "
            "probability 0, a single-option choice, or a contradictory "
            "activation condition): its parameters receive no "
            "observations and silently stay at the prior.",
        ),
        Rule(
            "SP108", Severity.WARNING, "int-cast-truncation",
            "An integer-valued distribution has parameters the final "
            "int() cast will truncate asymmetrically: non-integer q on "
            "uniformint/randint bounds, or a (high-low) span that is "
            "not a multiple of q (the top lattice point is clipped).",
        ),
    ]
}


@dataclass(frozen=True)
class Diagnostic:
    """One finding: rule id + severity + location + message + fix hint."""

    rule: str
    severity: str
    location: str  # graph path ("choice['m'][1].x") or "file.py:123"
    message: str
    hint: str = ""

    def format(self) -> str:
        s = f"{self.location}: {self.severity}: {self.rule} " \
            f"[{RULES[self.rule].title if self.rule in RULES else '?'}]: " \
            f"{self.message}"
        if self.hint:
            s += f"\n    hint: {self.hint}"
        return s


def make(rule: str, location: str, message: str, hint: str = "",
         severity: Optional[str] = None) -> Diagnostic:
    """Build a Diagnostic with the catalog's default severity."""
    if severity is None:
        severity = RULES[rule].severity if rule in RULES else Severity.WARNING
    return Diagnostic(rule=rule, severity=severity, location=location,
                      message=message, hint=hint)


def apply_suppressions(
    diags: Iterable[Diagnostic], suppress: Iterable[str] = ()
) -> List[Diagnostic]:
    sset = set(suppress or ())
    return [d for d in diags if d.rule not in sset]


# ---------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------


def sort_diagnostics(diags: Iterable[Diagnostic]) -> List[Diagnostic]:
    return sorted(
        diags, key=lambda d: (severity_rank(d.severity), d.rule, d.location)
    )


def format_report(diags: Iterable[Diagnostic], header: str = "") -> str:
    diags = sort_diagnostics(diags)
    lines = []
    if header:
        lines.append(header)
    if not diags:
        lines.append("no diagnostics")
    else:
        lines.extend(d.format() for d in diags)
        n_err = sum(1 for d in diags if d.severity == Severity.ERROR)
        n_warn = sum(1 for d in diags if d.severity == Severity.WARNING)
        lines.append(
            f"{len(diags)} diagnostic(s): {n_err} error(s), "
            f"{n_warn} warning(s)"
        )
    return "\n".join(lines)


def has_errors(diags: Iterable[Diagnostic]) -> bool:
    return any(d.severity == Severity.ERROR for d in diags)
