"""hyperopt_tpu_torch.control — the closed-loop control plane.

The service tunes its own serving knobs with its own optimizer:
a :class:`~.knobs.KnobSet` exposes the scheduler's live parameters
(batch window, batch size k, admission limit, speculation depth) as a
thread-safe runtime-settable table; a :class:`~.controller.Controller`
thread runs ``tpe.suggest`` over a bounded ``hp.*`` space of those
knobs, scoring each configuration over one SLO snapshot window
(:class:`~.objective.ObjectiveProbe`) and journaling its own Trials
durably so a restart resumes the optimization exactly; and
:mod:`.actuation` wires SH5xx search health into admission (stalled
studies release their slots).  Safety: guardrail-clamped proposals,
breach-triggered revert-to-static, exponential freeze/re-arm, and a
flight-recorded + traced decision log.  See ``docs/control.md``.
"""

from .actuation import STOP_RULES, build_stop_fn, evaluate_stop
from .controller import (
    DEFAULT_TUNED_KNOBS,
    Controller,
    ControlStats,
)
from .knobs import KNOB_SPECS, KnobSet, KnobSpec, guardrail_bounds
from .objective import ObjectiveProbe, WindowResult

__all__ = [
    "Controller",
    "ControlStats",
    "DEFAULT_TUNED_KNOBS",
    "KNOB_SPECS",
    "KnobSet",
    "KnobSpec",
    "ObjectiveProbe",
    "STOP_RULES",
    "WindowResult",
    "build_stop_fn",
    "evaluate_stop",
    "guardrail_bounds",
]
