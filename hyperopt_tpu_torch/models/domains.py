"""Benchmark objective zoo.

Reference parity (SURVEY.md §4): ``hyperopt/tests/test_domains.py`` —
``quadratic1``, ``q1_lognormal``, ``q1_choice``, ``n1``, ``gauss_wave``,
``gauss_wave2``, ``distractor``, ``branin``, ``many_dists`` — each a
(space, loss) pair; test suites parametrize over them, and BASELINE.md's
conformance configs (Branin-2D, Hartmann-6D) live here too.

Each domain is a :class:`BenchDomain` with a ``space``, an objective
``fn(config) -> loss``, and a ``quality_threshold``: the loss an optimizer
should reach within ``quality_evals`` trials (the reference's
"optimization-quality thresholds per benchmark domain" test pattern —
robust to RNG/backend change, unlike bitwise asserts).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np

from .. import hp


@dataclass
class BenchDomain:
    name: str
    space: object
    fn: Callable
    quality_threshold: float  # best loss an optimizer should reach ...
    quality_evals: int        # ... within this many trials
    fmin: float = float("nan")  # known global minimum (if any)


def _quadratic1():
    space = {"x": hp.uniform("x", -5, 5)}
    return BenchDomain(
        "quadratic1", space, lambda c: (c["x"] - 3) ** 2,
        quality_threshold=0.2, quality_evals=50, fmin=0.0,
    )


def _q1_lognormal():
    space = {"x": hp.qlognormal("x", 0, 2, 1)}
    return BenchDomain(
        "q1_lognormal", space,
        lambda c: max(c["x"], 0) ** 2 * 1e-2 + abs(c["x"] - 3) * 0.1,
        quality_threshold=0.5, quality_evals=50,
    )


def _q1_choice():
    space = hp.choice(
        "mode",
        [
            {"use": "left", "x": hp.uniform("xl", -10, 0)},
            {"use": "right", "x": hp.uniform("xr", 0, 10)},
        ],
    )
    def fn(c):
        return (c["x"] - 3) ** 2
    return BenchDomain("q1_choice", space, fn, quality_threshold=0.5, quality_evals=80, fmin=0.0)


def _n1():
    space = {"x": hp.normal("x", 0, 1)}
    return BenchDomain(
        "n1", space, lambda c: c["x"], quality_threshold=-1.5, quality_evals=60
    )


def _gauss_wave():
    space = {"x": hp.uniform("x", -20, 20)}
    def fn(c):
        x = c["x"]
        return -math.exp(-((x / 10.0) ** 2)) * math.cos(x)
    return BenchDomain("gauss_wave", space, fn, quality_threshold=-0.9, quality_evals=80, fmin=-1.0)


def _gauss_wave2():
    space = {
        "curve": hp.choice("curve", [{"kind": "flat"}, {"kind": "wave", "amp": hp.uniform("amp", 0.5, 2.0)}]),
        "x": hp.uniform("x", -20, 20),
    }
    def fn(c):
        x = c["x"]
        base = -math.exp(-((x / 10.0) ** 2))
        if c["curve"]["kind"] == "wave":
            return base * math.cos(x) * c["curve"]["amp"]
        return base * 0.5
    return BenchDomain("gauss_wave2", space, fn, quality_threshold=-1.0, quality_evals=120)


def _distractor():
    # global optimum in a narrow basin at x=-5; broad distractor basin at x=5
    space = {"x": hp.uniform("x", -15, 15)}
    def fn(c):
        x = c["x"]
        return -(1.2 * math.exp(-((x + 5.0) ** 2) / 0.5) + math.exp(-((x - 5.0) ** 2) / 18.0))
    return BenchDomain("distractor", space, fn, quality_threshold=-0.9, quality_evals=150, fmin=-1.2)


def _branin():
    # Branin-Hoo: global minimum 0.397887 at three points
    space = {"x": hp.uniform("x", -5.0, 10.0), "y": hp.uniform("y", 0.0, 15.0)}
    def fn(c):
        x, y = c["x"], c["y"]
        a, b, cc = 1.0, 5.1 / (4 * math.pi ** 2), 5.0 / math.pi
        r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
        return a * (y - b * x ** 2 + cc * x - r) ** 2 + s * (1 - t) * math.cos(x) + s
    return BenchDomain("branin", space, fn, quality_threshold=1.0, quality_evals=100, fmin=0.397887)


_H6_ALPHA = np.array([1.0, 1.2, 3.0, 3.2])
_H6_A = np.array(
    [
        [10, 3, 17, 3.5, 1.7, 8],
        [0.05, 10, 17, 0.1, 8, 14],
        [3, 3.5, 1.7, 10, 17, 8],
        [17, 8, 0.05, 10, 0.1, 14],
    ]
)
_H6_P = 1e-4 * np.array(
    [
        [1312, 1696, 5569, 124, 8283, 5886],
        [2329, 4135, 8307, 3736, 1004, 9991],
        [2348, 1451, 3522, 2883, 3047, 6650],
        [4047, 8828, 8732, 5743, 1091, 381],
    ]
)


def _hartmann6():
    # 6-D Hartmann: global minimum -3.32237
    space = {f"x{i}": hp.uniform(f"x{i}", 0.0, 1.0) for i in range(6)}
    def fn(c):
        x = np.array([c[f"x{i}"] for i in range(6)])
        inner = np.sum(_H6_A * (x - _H6_P) ** 2, axis=1)
        return float(-np.sum(_H6_ALPHA * np.exp(-inner)))
    return BenchDomain("hartmann6", space, fn, quality_threshold=-2.5, quality_evals=150, fmin=-3.32237)


def _many_dists():
    space = {
        "a": hp.choice("a", [0, 1, 2]),
        "b": hp.randint("b", 10),
        "c": hp.uniform("c", 4, 7),
        "d": hp.loguniform("d", -2, 0),
        "e": hp.quniform("e", 0, 10, 3),
        "f": hp.qloguniform("f", 0, 3, 2),
        "g": hp.normal("g", 4, 7),
        "h": hp.lognormal("h", -2, 2),
        "i": hp.qnormal("i", 0, 10, 2),
        "j": hp.qlognormal("j", 0, 2, 1),
        "k": hp.pchoice("k", [(0.1, 0), (0.9, 1)]),
        "z": hp.uniform("z", -5, 5),
    }
    def fn(c):
        return float(c["z"] ** 2 + 0.01 * (c["c"] + c["d"] + c["a"]))
    return BenchDomain("many_dists", space, fn, quality_threshold=0.5, quality_evals=80)


def _nested_arch():
    """Deep conditional space (ML-architecture shaped): a top-level
    branch choice where one branch carries an inner choice — exercises
    multi-level activity masks the way the reference's conditional
    test spaces do (hyperopt/tests/test_domains.py many_dists/choice)."""
    space = hp.choice(
        "arch",
        [
            {
                "kind": 0,
                "lr": hp.loguniform("mlp_lr", -6.0, 0.0),
                "width": hp.quniform("mlp_width", 16, 128, 16),
            },
            {
                "kind": 1,
                "lr": hp.loguniform("cnn_lr", -6.0, 0.0),
                "block": hp.choice(
                    "cnn_block",
                    [
                        {"b": 0, "filters": hp.quniform("f_a", 8, 64, 8)},
                        {"b": 1, "depth": hp.quniform("f_b", 1, 4, 1)},
                    ],
                ),
            },
        ],
    )

    def fn(c):
        # optimum: cnn branch, block b=0, lr≈e^-3, filters≈40
        lr_term = (math.log(c["lr"]) + 3.0) ** 2
        if c["kind"] == 0:
            return 1.0 + lr_term + abs(c["width"] - 64) / 64.0
        if c["block"]["b"] == 0:
            return lr_term + abs(c["block"]["filters"] - 40) / 40.0
        return 0.5 + lr_term + abs(c["block"]["depth"] - 2) / 2.0

    return BenchDomain(
        "nested_arch", space, fn, quality_threshold=0.5, quality_evals=120, fmin=0.0
    )


def _rosen10():
    """10-D Rosenbrock on [-2, 2]^10 — the zoo's high-dimensional
    continuous domain (history_per_param stays small even at many
    trials, the regime the ATPE featurizer must see in training)."""
    space = {f"r{i}": hp.uniform(f"r{i}", -2.0, 2.0) for i in range(10)}

    def fn(c):
        x = np.array([c[f"r{i}"] for i in range(10)])
        return float(
            np.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)
        )

    return BenchDomain(
        "rosen10", space, fn, quality_threshold=900.0, quality_evals=150, fmin=0.0
    )


def _make_all():
    ds = [
        _quadratic1(),
        _q1_lognormal(),
        _q1_choice(),
        _n1(),
        _gauss_wave(),
        _gauss_wave2(),
        _distractor(),
        _branin(),
        _hartmann6(),
        _many_dists(),
        _nested_arch(),
        _rosen10(),
    ]
    return {d.name: d for d in ds}


DOMAINS = _make_all()


def get(name: str) -> BenchDomain:
    return DOMAINS[name]
