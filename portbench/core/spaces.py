"""Search spaces as data, and prior draws in NumPy.

A configuration file lists its labels as plain records::

    {"label": "eta", "dist": "loguniform", "low": -6.93, "high": 0.0}

Log distributions carry their bounds (or ``mu``/``sigma``) in log space,
as ``hp`` takes them.  ``choice`` lists ``options``, ``pchoice`` lists
``p`` and ``options``, ``randint`` takes ``upper`` or ``low``/``high``.

Nothing here imports the program: :func:`build_space` is handed the
program's ``hp`` module by the caller.  Prior draws are NumPy's, from the
seed (:mod:`.history` makes a cell's history with them).
"""

from __future__ import annotations

import numpy as np

CONTINUOUS = ("uniform", "loguniform", "normal", "lognormal")
QUANTIZED = ("quniform", "qloguniform", "qnormal", "qlognormal")
INDEX = ("randint", "choice", "pchoice")
LOG = ("loguniform", "lognormal", "qloguniform", "qlognormal")
BOUNDED = ("uniform", "loguniform", "quniform", "qloguniform")
# float32 values compare against float64 bounds with this relative room
F32_REL = 4.0 * 2.0 ** -23


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """An independent NumPy stream for ``(seed, *tags)``; any whole seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 63, *tags]))


def build_space(hp, labels):
    """The flat ``{label: hp node}`` space through the program's ``hp``."""
    space = {}
    for lab in labels:
        name, d = lab["label"], lab["dist"]
        if d in ("uniform", "loguniform"):
            node = getattr(hp, d)(name, lab["low"], lab["high"])
        elif d in ("quniform", "qloguniform"):
            node = getattr(hp, d)(name, lab["low"], lab["high"], lab["q"])
        elif d in ("normal", "lognormal"):
            node = getattr(hp, d)(name, lab["mu"], lab["sigma"])
        elif d in ("qnormal", "qlognormal"):
            node = getattr(hp, d)(name, lab["mu"], lab["sigma"], lab["q"])
        elif d == "randint":
            node = hp.randint(name, *randint_bounds(lab)) if "low" in lab else \
                hp.randint(name, lab["upper"])
        elif d == "choice":
            node = hp.choice(name, list(lab["options"]))
        elif d == "pchoice":
            node = hp.pchoice(name, list(zip(lab["p"], lab["options"])))
        else:
            raise ValueError(f"unknown dist {d!r} for label {name!r}")
        space[name] = node
    return space


def randint_bounds(lab):
    """``(low, high)`` of a randint label, ``high`` exclusive."""
    if "low" in lab:
        return int(lab["low"]), int(lab["high"])
    return 0, int(lab["upper"])


def n_categories(lab) -> int:
    if lab["dist"] == "randint":
        low, high = randint_bounds(lab)
        return high - low
    return len(lab["options"])


def prior_p(lab):
    """The prior category probabilities of an index label."""
    if lab["dist"] == "pchoice":
        p = np.asarray(lab["p"], np.float64)
        return p / p.sum()
    k = n_categories(lab)
    return np.full(k, 1.0 / k)


def index_offset(lab) -> int:
    return randint_bounds(lab)[0] if lab["dist"] == "randint" else 0


def sample_prior(lab, rng, n):
    """``n`` values of one label drawn from its prior, as the program
    records them (``misc["vals"]``): category indices for choices, the
    integer itself for randint, floats otherwise."""
    d = lab["dist"]
    if d in INDEX:
        if d == "randint":
            low, high = randint_bounds(lab)
            return rng.integers(low, high, size=n).astype(np.int64)
        return rng.choice(n_categories(lab), size=n, p=prior_p(lab)).astype(np.int64)
    if d in ("uniform", "loguniform", "quniform", "qloguniform"):
        x = rng.uniform(lab["low"], lab["high"], size=n)
    else:
        x = rng.normal(lab["mu"], lab["sigma"], size=n)
    if d in LOG:
        x = np.exp(x)
    if d in QUANTIZED:
        x = np.round(x / lab["q"]) * lab["q"]
    # the program keeps float32 values on the card: draw them exactly so
    return x.astype(np.float32).astype(np.float64)


def point_from_vals(labels, vals):
    """The objective's argument from recorded values (options for choices).
    ``vals`` maps a label to a scalar or to an array of values."""
    point = {}
    for lab in labels:
        v = vals[lab["label"]]
        if lab["dist"] in ("choice", "pchoice"):
            opts = np.asarray(lab["options"])
            point[lab["label"]] = opts[np.asarray(v, np.int64)]
        else:
            point[lab["label"]] = v
    return point


def in_support(lab, v) -> bool:
    """Is ``v`` (a recorded value) one the label can take?"""
    d = lab["dist"]
    if v is None or not np.isfinite(v):
        return False
    if d in INDEX:
        if float(v) != int(v):
            return False
        if d == "randint":
            low, high = randint_bounds(lab)
            return low <= int(v) < high
        return 0 <= int(v) < n_categories(lab)
    v = float(v)
    if d in QUANTIZED:
        q = float(lab["q"])
        k = v / q
        if abs(k - round(k)) > F32_REL * max(1.0, abs(k)):
            return False
    if d in ("lognormal", "loguniform") and v <= 0:
        return False
    if d in ("qlognormal", "qloguniform") and v < 0:
        return False
    if d in BOUNDED:
        lo, hi = float(lab["low"]), float(lab["high"])
        if d in LOG:
            lo, hi = np.exp(lo), np.exp(hi)
        if d in QUANTIZED:
            q = float(lab["q"])
            lo, hi = q * np.round(lo / q), q * np.round(hi / q)
        room = F32_REL * max(abs(lo), abs(hi), 1e-30)
        return lo - room <= v <= hi + room
    return True

