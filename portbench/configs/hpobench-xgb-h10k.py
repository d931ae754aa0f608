"""The objective of ``hpobench-xgb-h10k``: a synthetic validation loss.

HPOBench's tabular XGBoost losses are not in the repository, so the loss
is a fixed smooth surface over the space's unit cube (log scale where
the space is): a bowl with a centre and a curvature per axis, one
interaction and a ripple, its constants drawn once from seed 0.  Every
run's seed draws another history on the same surface, so the work of a
window (how often a new trial lands among the γ best) is the same from
seed to seed.  It returns float32-exact values.
"""

import math

import numpy as np

CENTRE = np.array([0.2233, 0.6663, 0.6795, 0.4859])
CURVE = np.array([0.2602, 0.2871, 0.081, 0.1837])
CROSS, PHASE = -0.0092, 5.7136


def loss(point):
    """``point`` maps each label to a value or to an array of values."""
    u = np.stack([
        (np.log(np.asarray(point["eta"], np.float64)) + 10 * math.log(2)) / (10 * math.log(2)),
        np.log(np.maximum(np.asarray(point["max_depth"], np.float64), 1.0)) / math.log(50),
        (np.asarray(point["colsample_bytree"], np.float64) - 0.1) / 0.9,
        (np.log(np.asarray(point["reg_lambda"], np.float64)) + 10 * math.log(2)) / (20 * math.log(2)),
    ])
    d = u - CENTRE.reshape((4,) + (1,) * (u.ndim - 1))
    value = (0.05 + np.tensordot(CURVE, d * d, axes=1) + CROSS * d[0] * d[1]
             + 0.01 * np.sin(7 * u[0] + 5 * u[2] + PHASE))
    return np.asarray(value, np.float32).astype(np.float64)
