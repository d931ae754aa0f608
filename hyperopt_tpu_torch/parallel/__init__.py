"""Parallel execution backends.

:mod:`torch_trials` — ``TorchTrials``: batched asynchronous trial
execution (the analog of ``hyperopt_tpu``'s ``JaxTrials`` and the
reference's ``SparkTrials``: a thread-pool dispatcher with timeout→cancel)
plus one vectorized call on the card for objectives written in torch.
"""

from .torch_trials import TorchTrials

__all__ = ["TorchTrials"]
