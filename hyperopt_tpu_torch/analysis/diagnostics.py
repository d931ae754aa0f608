"""Shared structured-diagnostic model of the port's analysis passes.

Every pass (:mod:`space_lint`, :mod:`program_lint`, :mod:`race_lint`,
:mod:`durability_lint`, :mod:`protocol_lint`) emits :class:`Diagnostic`
records — rule id, severity, location (graph path for spaces,
``file:line`` for source), message, fix hint — so one reporter, one
suppression mechanism, and one gate serve all of them.

Rule ids, titles and wording are the reference's
(``hyperopt_tpu/analysis/diagnostics.py``), so one diagnostic reads the
same from both packages: ``SP1xx`` space rules, ``PL205``/``PL208``
program rules (the recompile audit and the dispatch-container check; the
reference's other ``PL2xx`` rules audit jitted, donated or partitioned
programs, which the port does not have), ``RL3xx`` race rules, ``DL4xx``
durability rules, ``SG7xx`` segment-protocol rules.  (``FS4xx`` ids are
fsck *repair* rules, not analyzer rules — they live in
:mod:`hyperopt_tpu_torch.resilience.fsck`.)

Suppression:

- API: every ``lint_*`` entry point accepts ``suppress=("SP105", ...)``.
- Source comments (AST passes): ``# lint: disable=RL301`` on the
  flagged line suppresses that rule there; ``# lint: disable`` with no
  ids suppresses every rule on the line.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple


# One definition of "this name smells like a lock" shared by the race
# and durability passes, so both draw the same lock boundaries.
LOCKISH_RE = re.compile(r"lock|mutex|cond|cv\b|sem", re.IGNORECASE)


def dotted_chain(node: ast.AST) -> Tuple[str, ...]:
    """Dotted chain of an attribute/name expression, outermost-first:
    ``('os', 'replace')`` for ``os.replace``, ``('self', '_thread',
    'join')`` for ``self._thread.join``, ``('join',)`` when the root is
    dynamic (a call result, subscript, ...).  Shared by the AST passes
    so call-target matching stays consistent across them."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


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


# ---------------------------------------------------------------------
# Rule catalog (listed in README.md's port section)
# ---------------------------------------------------------------------

RULES = {
    r.id: r
    for r in [
        # -- space_lint ------------------------------------------------
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
        # -- program_lint ----------------------------------------------
        Rule(
            "PL205", Severity.ERROR, "excess-retrace",
            "A fused device program re-traced for a (trial-count "
            "bucket, family) it had already compiled: the jit cache "
            "key leaks a per-call value, and every suggest pays a "
            "recompile instead of O(log N) compiles per run.",
        ),
        Rule(
            "PL208", Severity.ERROR, "unnormalized-dispatch-container",
            "A dispatch call site hands the fused suggest program a "
            "request whose args ride in a list instead of the "
            "normalized tuple form: the container type is part of the "
            "jit pytree key, so the same workload silently retraces "
            "per call.",
        ),
        # -- race_lint -------------------------------------------------
        Rule(
            "RL301", Severity.ERROR, "unguarded-access",
            "A field annotated '# guarded-by: <lock>' is read or "
            "written outside a 'with self.<lock>:' block (and outside "
            "__init__): a concurrent mutator can interleave.",
        ),
        Rule(
            "RL302", Severity.ERROR, "lock-order-inversion",
            "Locks are acquired in an order that contradicts the "
            "declared '# lock-order:' — two threads taking them in "
            "opposite orders deadlock.",
        ),
        Rule(
            "RL303", Severity.WARNING, "unknown-guard",
            "A '# guarded-by:' annotation names a lock that is never "
            "assigned in the class: the annotation is stale or "
            "misspelled, so the discipline it declares is unchecked.",
        ),
        Rule(
            "RL304", Severity.ERROR, "lock-cycle",
            "The observed lock-acquisition graph (nested 'with' "
            "blocks plus same-scope method calls made under a lock) "
            "contains a cycle: two threads walking the cycle from "
            "different entry points deadlock.",
        ),
        Rule(
            "RL305", Severity.WARNING, "blocking-call-under-lock",
            "A blocking call (fsync, HTTP, device dispatch/readback, "
            "thread join) is made while holding a lock: every thread "
            "contending on that lock stalls behind the disk/network/"
            "device, and a join can deadlock against the joined "
            "thread taking the same lock.",
        ),
        Rule(
            "RL306", Severity.ERROR, "unregistered-lock-module",
            "A module constructs a threading.Lock/RLock/Condition but "
            "carries no guarded-by annotations and is not explicitly "
            "exempted: its lock discipline is invisible to the race "
            "pass, so violations in it can never be caught.",
        ),
        # -- durability_lint ---------------------------------------------
        Rule(
            "DL401", Severity.ERROR, "truncate-live-path",
            "A live (non-tmp) file is opened with a truncating mode: "
            "a crash between the truncate and the write leaves the "
            "path EMPTY (the ids.counter tear class — duplicate trial "
            "ids on restart).  Durable writes must go write-tmp -> "
            "fsync -> os.replace.",
        ),
        Rule(
            "DL402", Severity.ERROR, "replace-without-fsync",
            "os.replace/os.rename publishes a tmp file written in the "
            "same function without an fsync on the source handle: "
            "after a power loss the rename can survive while the data "
            "does not, leaving a durable path pointing at garbage.",
        ),
        Rule(
            "DL403", Severity.ERROR, "unframed-journal-append",
            "An O_APPEND journal append is not CRC-framed or is built "
            "from multiple write() calls: a torn append becomes "
            "indistinguishable from a valid record (or tears across "
            "records), defeating the resync-on-load discipline.",
        ),
        Rule(
            "DL404", Severity.WARNING, "dangling-tmp",
            "A tmp file is created outside the atomic-replace idiom "
            "(no os.replace publishing it in the same function): "
            "either the write is not actually atomic, or droppings "
            "accumulate forever.",
        ),
        Rule(
            "DL405", Severity.ERROR, "unlocked-read-modify-write",
            "A shared file is read and then rewritten in the same "
            "function with no lock and no O_APPEND: two concurrent "
            "writers interleave read-modify-write and one update is "
            "silently lost.",
        ),
        # -- protocol_lint -----------------------------------------------
        Rule(
            "SG701", Severity.ERROR, "unvalidated-durable-commit",
            "A replication-write site publishes its commit point (the "
            "manifest) without a fence validation immediately before "
            "it, or an orphan sweep unlinks a segment with no "
            "straggler re-home preceding the unlink: a stale mirror "
            "can commit over a takeover, or acked records that exist "
            "nowhere else are destroyed.",
        ),
        Rule(
            "SG702", Severity.ERROR, "write-after-manifest-publish",
            "A durable write follows the manifest publish in a "
            "replication-write site: the manifest is the commit point, "
            "so anything written after it is either unreferenced "
            "(wasted) or — for sidecars — can clobber post-takeover "
            "state the already-published manifest now governs.",
        ),
        Rule(
            "SG703", Severity.ERROR, "non-contiguous-cursor-advance",
            "A replay cursor/offset is advanced past bytes the view "
            "never applied: a max(cursor, end)-style jump, or an "
            "unguarded advance in a cursor-advance site (no "
            "contiguity equality check dominating the assignment).  "
            "Under O_APPEND another process's records can land in the "
            "gap and be skipped forever.",
        ),
        Rule(
            "SG704", Severity.ERROR, "shared-lock-unlink",
            "A stale shared lock file is broken by unlinking the "
            "shared path directly (inside the FileExistsError "
            "acquire path): two breakers that both judged the lock "
            "stale can each unlink-and-recreate, ending up inside the "
            "critical section concurrently.  Rename the lock to a "
            "private name first — only one breaker wins the rename.",
        ),
        Rule(
            "SG705", Severity.ERROR, "pull-without-ownership-check",
            "A replication-write site performs a durable write before "
            "checking destination ownership: a mirror tick racing a "
            "local takeover overwrites the live manifest, response "
            "journal, seed cursor, or id counter with the stale "
            "source snapshot.",
        ),
        Rule(
            "SG706", Severity.ERROR, "protocol-model-violation",
            "The explicit-state protocol model checker found an "
            "interleaving (with at most one crash injected after a "
            "durable step) that violates a store/replication "
            "invariant: an acked record is lost, two sealers enter "
            "the critical section, the manifest dangles, a fence "
            "moves backwards, or a replayed view diverges from the "
            "log.  The diagnostic carries the violating schedule.",
        ),
        Rule(
            "SG707", Severity.WARNING, "unknown-protocol-annotation",
            "A '# protocol:' annotation names a role the protocol "
            "pass does not know, or attaches to no function: the "
            "discipline it was meant to declare is unchecked.",
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


# ---------------------------------------------------------------------
# Suppression
# ---------------------------------------------------------------------

_DISABLE_RE = re.compile(r"#\s*lint:\s*disable(?:=([A-Z0-9, ]+))?")


def line_suppressions(source_line: str) -> Optional[frozenset]:
    """Rule ids disabled by a ``# lint: disable=...`` comment on the
    line, ``frozenset()`` for a bare ``# lint: disable`` (all rules),
    or None when the line has no suppression comment."""
    m = _DISABLE_RE.search(source_line)
    if m is None:
        return None
    if m.group(1) is None:
        return frozenset()
    return frozenset(x.strip() for x in m.group(1).split(",") if x.strip())


def suppressed_by_comment(rule: str, source_line: str) -> bool:
    sup = line_suppressions(source_line)
    if sup is None:
        return False
    return len(sup) == 0 or rule in sup


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
