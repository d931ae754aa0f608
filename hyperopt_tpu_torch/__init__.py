"""hyperopt_tpu_torch — the PyTorch/CUDA port of ``hyperopt_tpu``.

The same ``hp.*`` search-space DSL, ``fmin`` driver, ``Trials`` store,
algorithm suite (``rand``, ``anneal``, ``tpe``, ``atpe``, ``mix``) and
``TorchTrials`` (the analog of ``JaxTrials``), ``FileTrials`` (the
durable multi-process queue, served by ``hyperopt-tpu-torch-worker``),
with TPE's numeric core on
an NVIDIA card: the history lives in device tensors and the
O(candidates × history) pair score runs in a CUDA kernel written for
Hopper (``csrc/``).  It
imports torch, numpy and scipy, never JAX or ``hyperopt_tpu``.

Entry points run on the CUDA card unless the caller asks for the CPU, e.g.
``partial(tpe.suggest, device="cpu")``.  The two plugin boundaries of the
reference are kept: ``suggest(new_ids, domain, trials, seed)`` for
algorithms and ``Trials`` subclassing for execution backends.
"""

from functools import partial

from . import hp, pyll
from .algos import anneal, atpe, criteria, mix, rand, tpe
from .base import (
    JOB_STATE_CANCEL,
    JOB_STATE_DONE,
    JOB_STATE_ERROR,
    JOB_STATE_NEW,
    JOB_STATE_RUNNING,
    JOB_STATES,
    STATUS_FAIL,
    STATUS_NEW,
    STATUS_OK,
    STATUS_RUNNING,
    STATUS_STRINGS,
    STATUS_SUSPENDED,
    Ctrl,
    Domain,
    Trials,
    trials_from_docs,
)
from .early_stop import no_progress_loss, no_progress_stop
from .exceptions import (
    AllTrialsFailed,
    BadSearchSpace,
    DuplicateLabel,
    InvalidLoss,
    InvalidResultStatus,
    InvalidSpaceError,
    InvalidTrial,
)
from .fmin import (
    FMinIter,
    fmin,
    fmin_pass_expr_memo_ctrl,
    generate_trials_to_calculate,
    space_eval,
)
from .parallel import FileTrials, TorchTrials

# migration stubs for reference-hyperopt users: the Mongo/Spark backends
# are delivered by analogs, not ports.  Real (but unconstructable)
# classes, not module __getattr__, because the common migration form
# `from hyperopt import MongoTrials` swallows AttributeError into a bare
# ImportError and would lose the guidance.


class MongoTrials:
    """Not provided — use :class:`FileTrials`.

    The durable multi-worker queue is FileTrials (shared-filesystem
    analog of the reference's Mongo backend; workers run
    ``hyperopt-tpu-torch-worker --queue DIR``)."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "hyperopt_tpu_torch has no MongoTrials: use FileTrials(queue_dir) "
            "— the durable shared-filesystem work queue (workers: "
            "`hyperopt-tpu-torch-worker --queue DIR`)."
        )


class SparkTrials:
    """Not provided — use :class:`TorchTrials`.

    Concurrent trial execution is TorchTrials(parallelism=N) (thread
    dispatcher + optional vectorized evaluation on the card)."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "hyperopt_tpu_torch has no SparkTrials: use "
            "TorchTrials(parallelism=N) — concurrent trials with an optional "
            "batch plane on the card."
        )


__version__ = "0.1.0"

__all__ = [
    "AllTrialsFailed",
    "BadSearchSpace",
    "Ctrl",
    "Domain",
    "DuplicateLabel",
    "FMinIter",
    "FileTrials",
    "InvalidLoss",
    "InvalidResultStatus",
    "InvalidSpaceError",
    "InvalidTrial",
    "JOB_STATES",
    "JOB_STATE_CANCEL",
    "JOB_STATE_DONE",
    "JOB_STATE_ERROR",
    "JOB_STATE_NEW",
    "JOB_STATE_RUNNING",
    "MongoTrials",
    "STATUS_FAIL",
    "STATUS_NEW",
    "STATUS_OK",
    "STATUS_RUNNING",
    "STATUS_STRINGS",
    "STATUS_SUSPENDED",
    "SparkTrials",
    "TorchTrials",
    "Trials",
    "anneal",
    "atpe",
    "criteria",
    "fmin",
    "fmin_pass_expr_memo_ctrl",
    "generate_trials_to_calculate",
    "hp",
    "mix",
    "no_progress_loss",
    "no_progress_stop",
    "partial",
    "pyll",
    "rand",
    "space_eval",
    "tpe",
    "trials_from_docs",
]
