"""hyperopt_tpu_torch.service — the multi-study optimization service.

One long-lived server process owns the CUDA card and multiplexes many
concurrent studies onto it through a continuous-batching scheduler:
concurrent ``suggest`` requests are coalesced within a short window and
launched back to back as ONE batched dispatch with one readback
(``tpe_device.multi_study_suggest_async``), with per-study durable
state (FileTrials), admission-control backpressure (HTTP 429), and
graceful drain.  Several such processes may share one ``--root`` as
replicas (``--replica-id``), each serving the studies it leases.
Reference parity: ``hyperopt_tpu/service``.

Quick start::

    # server (one per host; owns the card; --device cpu without one)
    python -m hyperopt_tpu_torch.service --root /srv/hyperopt --port 8777

    # client
    from hyperopt_tpu_torch import hp
    from hyperopt_tpu_torch.service import ServiceClient
    client = ServiceClient("http://127.0.0.1:8777")
    client.minimize("my-study", objective,
                    {"x": hp.uniform("x", -5, 5)}, max_evals=100)
"""

from ..resilience.retry import CircuitOpenError
from .client import (
    ReplicaRedirect,
    ServiceClient,
    ServiceClientError,
    ServiceTransportError,
    parse_retry_after,
)
from .core import (
    BackpressureError,
    NotOwner,
    OptimizationService,
    ResponseJournal,
    ServiceDraining,
    Study,
    StudyExists,
    StudyNotFound,
    StudyRegistry,
    StudyStopped,
    SuggestScheduler,
    canonical_json,
    decode_space,
    encode_space,
)
from .replicas import (
    HashRing,
    OwnershipLost,
    ReplicaDirectory,
    ReplicaSet,
    StudyLeaseStore,
    read_discovery,
)
from .server import ServiceServer, free_port

__all__ = [
    "BackpressureError",
    "CircuitOpenError",
    "HashRing",
    "NotOwner",
    "OptimizationService",
    "OwnershipLost",
    "ReplicaDirectory",
    "ReplicaRedirect",
    "ReplicaSet",
    "ResponseJournal",
    "ServiceClient",
    "ServiceClientError",
    "ServiceDraining",
    "ServiceServer",
    "ServiceTransportError",
    "Study",
    "StudyExists",
    "StudyLeaseStore",
    "StudyNotFound",
    "StudyRegistry",
    "StudyStopped",
    "SuggestScheduler",
    "canonical_json",
    "decode_space",
    "encode_space",
    "free_port",
    "parse_retry_after",
    "read_discovery",
]
