"""Benchmark objectives and meta-model artifacts.

``domains`` is the benchmark-objective zoo (the reference ships it as
``hyperopt/tests/test_domains.py``; here it is a library module because the
benchmarks double as conformance + perf configs, see BASELINE.md).
``atpe_models`` holds the ATPE meta-model artifacts/heuristics, and
``train_atpe`` (``python -m hyperopt_tpu_torch.models.train_atpe``) is the
offline trainer that writes them.
"""

from . import domains

__all__ = ["domains"]
