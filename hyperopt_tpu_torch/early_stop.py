"""Early-stopping policies.

Reference parity (SURVEY.md §2 #19): ``hyperopt/early_stop.py`` —
``no_progress_loss(iteration_stop_count, percent_increase)`` — and
``hyperopt_tpu/early_stop.py``'s ``no_progress_stop``, the search-health
stop driven by :class:`~hyperopt_tpu_torch.diagnostics.SearchStats`.
"""

import logging

logger = logging.getLogger(__name__)


def no_progress_loss(iteration_stop_count=20, percent_increase=0.0):
    """Stop if the best loss has not improved for ``iteration_stop_count``
    consecutive trials (improvement must beat ``percent_increase`` %).

    Returns a callable with the early_stop_fn protocol:
    ``(trials, *args) -> (stop: bool, new_args: list)``.
    """

    def stop_fn(trials, best_loss=None, iteration_no_progress=0):
        new_loss = trials.trials[len(trials.trials) - 1]["result"].get("loss")
        if best_loss is None:
            return False, [new_loss, iteration_no_progress + 1]
        best_loss_threshold = best_loss - abs(best_loss * (percent_increase / 100.0))
        if new_loss is not None and new_loss < best_loss_threshold:
            best_loss = new_loss
            iteration_no_progress = 0
        else:
            iteration_no_progress += 1
            logger.debug(
                "No progress made: %d iteration on %d. best_loss=%.2f, new_loss=%.2f",
                iteration_no_progress,
                iteration_stop_count,
                best_loss if best_loss is not None else float("nan"),
                new_loss if new_loss is not None else float("nan"),
            )
        return (
            iteration_no_progress >= iteration_stop_count,
            [best_loss, iteration_no_progress],
        )

    return stop_fn


def no_progress_stop(iteration_stop_count=20, percent_increase=0.0,
                     n_startup_jobs=20, search_stats=None):
    """Opt-in early stop driven by the SH5xx health classifier: halt
    when the run's :class:`~hyperopt_tpu_torch.diagnostics.SearchStats` fires
    **SH502 STALLED** — no best-loss improvement (beyond
    ``percent_increase`` % of the window-ago best) over the last
    ``iteration_stop_count`` completed trials, evaluated only after the
    ``n_startup_jobs`` warm-up (random-phase noise must never trip it).

    Differences from :func:`no_progress_loss`: the verdict is computed
    from the *best-so-far trail* (an error or NaN trial cannot reset the
    stall counter the way ``no_progress_loss``'s last-loss comparison
    can), warm-up is excluded by construction, and the same rule id the
    fleet dashboards show is the one that stopped the run.

    ``search_stats``: pass the run's shared
    :class:`~hyperopt_tpu_torch.diagnostics.SearchStats` (e.g.
    ``fmin(search_stats=...)``) to reuse its counters; by default the
    hook owns a private instance fed incrementally from the trials
    object each callback.

    Returns a callable with the ``early_stop_fn`` protocol:
    ``(trials, *args) -> (stop: bool, new_args: list)``.
    """
    from .diagnostics import SearchStats

    stats = search_stats if search_stats is not None else SearchStats(
        n_startup_jobs=n_startup_jobs,
        stall_window=iteration_stop_count,
        stall_rel_improve=percent_increase / 100.0,
    )

    def stop_fn(trials, *args):
        stats.observe_trials(trials)
        health = stats.health()
        sh502 = next(
            (r for r in health["rules"] if r["rule"] == "SH502"), None
        )
        if sh502 is not None:
            # the hook acts on SH502 specifically, so log ITS detail —
            # a co-fired higher-priority rule may own health["state"]
            logger.info("no_progress_stop: %s", sh502["detail"])
        return sh502 is not None, []

    stop_fn.search_stats = stats
    return stop_fn
