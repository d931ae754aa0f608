"""Parallel execution backends.

:mod:`torch_trials` — ``TorchTrials``: batched asynchronous trial
execution (the analog of ``hyperopt_tpu``'s ``JaxTrials`` and the
reference's ``SparkTrials``: a thread-pool dispatcher with timeout→cancel)
plus one vectorized call on the card for objectives written in torch.

:mod:`file_trials` — ``FileTrials``: the durable filesystem work queue
with atomic reservation and heartbeat leases (the reference's
``MongoTrials`` analog), served by out-of-process workers
(:mod:`worker`, ``hyperopt-tpu-torch-worker --queue DIR``).

:mod:`sharding` — ``DeviceMesh`` and the ``dp × sp`` sharded scorers (the
mesh execution mode of ``tpe.suggest(mesh=...)``); :mod:`distributed` —
several processes forming one mesh over ``torch.distributed``.
"""

from . import distributed, sharding
from .file_trials import FileTrials
from .torch_trials import TorchTrials

__all__ = ["FileTrials", "TorchTrials", "distributed", "sharding"]
