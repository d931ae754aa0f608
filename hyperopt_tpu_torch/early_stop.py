"""Early-stopping policies.

Reference parity (SURVEY.md §2 #19): ``hyperopt/early_stop.py`` —
``no_progress_loss(iteration_stop_count, percent_increase)``.

The search-health stop (``no_progress_stop``) needs the ``SearchStats``
telemetry layer, which this package does not carry yet (ROADMAP queue A).
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
