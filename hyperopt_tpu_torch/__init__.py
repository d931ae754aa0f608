"""hyperopt_tpu_torch — the PyTorch/CUDA port of ``hyperopt_tpu``.

The same ``hp.*`` search-space DSL, ``fmin`` driver, ``Trials`` store,
algorithm suite (``rand``, ``anneal``, ``tpe``, ``atpe``, ``mix``) and
``TorchTrials`` (the analog of ``JaxTrials``), with TPE's numeric core on
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
from .parallel import TorchTrials

__version__ = "0.1.0"

__all__ = [
    "AllTrialsFailed",
    "BadSearchSpace",
    "Ctrl",
    "Domain",
    "DuplicateLabel",
    "FMinIter",
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
    "STATUS_FAIL",
    "STATUS_NEW",
    "STATUS_OK",
    "STATUS_RUNNING",
    "STATUS_STRINGS",
    "STATUS_SUSPENDED",
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
