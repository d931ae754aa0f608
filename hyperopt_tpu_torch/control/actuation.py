"""Fleet actuation: SH5xx search health wired into admission.

The second loop the control plane closes (ROADMAP "close the loop"):
a study that has provably stopped making progress — SH502 STALLED per
:func:`~hyperopt_tpu_torch.early_stop.no_progress_stop`'s criterion, or
SH505 SPACE_EXHAUSTED — is holding an admission slot
(``max_studies``) that a queued study could use.  With the per-study
``early_stop`` opt-in (default OFF — set at create), the service
checks the criterion after every landed report; a firing study
transitions to a terminal ``stopped`` status, its admission slot is
released (the registry's capacity check counts only active studies),
and the stop surfaces in ``/v1/studies/<id>``.  Every reclaim is
counted (``hyperopt_control_reclaimed_studies_total``) and reversible
(``resume_study`` re-admits the study, subject to capacity).

This module holds the pure pieces — the criterion evaluation and the
stop-record shape; the locking and registry bookkeeping live in
:mod:`hyperopt_tpu_torch.service.core`.
"""

import time

from ..early_stop import no_progress_stop

__all__ = ["build_stop_fn", "evaluate_stop", "STOP_RULES"]

# the SH5xx verdicts that reclaim an admission slot: a STALLED search
# past the no-progress window, or a space with nothing left to sample
STOP_RULES = ("SH502", "SH505")


def build_stop_fn(config: dict, n_startup_jobs=20):
    """The per-study hook from an ``early_stop`` create config::

        {"iteration_stop_count": 20, "percent_increase": 0.0}

    Wraps :func:`~hyperopt_tpu_torch.early_stop.no_progress_stop` with the
    study's own startup-jobs count (the random phase must never trip
    the stall window).  Raises ``ValueError`` on a malformed config —
    the create-path 400."""
    if not isinstance(config, dict):
        raise ValueError(
            f"early_stop must be a config dict, got {config!r}"
        )
    unknown = set(config) - {"iteration_stop_count", "percent_increase"}
    if unknown:
        raise ValueError(
            f"unknown early_stop keys: {sorted(unknown)}"
        )
    iteration_stop_count = int(config.get("iteration_stop_count", 20))
    if iteration_stop_count < 1:
        raise ValueError("iteration_stop_count must be >= 1")
    percent_increase = float(config.get("percent_increase", 0.0))
    return no_progress_stop(
        iteration_stop_count=iteration_stop_count,
        percent_increase=percent_increase,
        n_startup_jobs=int(n_startup_jobs),
    )


def evaluate_stop(stop_fn, trials):
    """None, or the terminal stop record for a study whose criterion
    fired.  Caller holds the study lock (the trials object is read).

    ``no_progress_stop`` fires on SH502 specifically; SPACE_EXHAUSTED
    (SH505) is checked from the same health evaluation — an exhausted
    space cannot progress by definition, so it reclaims the slot under
    the same opt-in."""
    stalled, _ = stop_fn(trials)
    health = stop_fn.search_stats.health()
    fired = [
        r for r in health["rules"] if r["rule"] in STOP_RULES
    ]
    if not stalled and not fired:
        return None
    return {
        "t": time.time(),
        "rule": fired[0]["rule"] if fired else "SH502",
        "rules": [r["rule"] for r in fired],
        "detail": (
            fired[0]["detail"] if fired else "no-progress stop fired"
        ),
        "state": health["state"],
    }
