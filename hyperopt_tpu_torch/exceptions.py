"""Framework exceptions.

Reference parity (SURVEY.md §2 #13): ``hyperopt/exceptions.py`` —
``AllTrialsFailed``, ``InvalidTrial``, ``InvalidResultStatus``,
``InvalidLoss``, ``DuplicateLabel``.
"""


class BadSearchSpace(Exception):
    """The search space is malformed."""


class InvalidSpaceError(BadSearchSpace):
    """A space parameter is statically invalid (inverted bounds,
    non-positive q/sigma, ...), caught at ``hp.*`` construction time or
    by the ``fmin(..., validate_space=True)`` pre-flight — instead of a
    device-side NaN many trials later.

    ``label`` is the offending hyperparameter's label (None when the
    failure is not tied to one label); ``diagnostics`` carries the
    structured findings when raised by the pre-flight."""

    def __init__(self, msg, label=None, diagnostics=()):
        super().__init__(msg)
        self.label = label
        self.diagnostics = tuple(diagnostics)


class DuplicateLabel(BadSearchSpace):
    """The same hyperparameter label is used by two distinct nodes."""


class InvalidTrial(ValueError):
    """A trial document does not have the required structure."""

    def __init__(self, msg, trial):
        super().__init__(msg, trial)
        self.trial = trial


class InvalidResultStatus(ValueError):
    """An objective returned a result dict with an invalid status."""

    def __init__(self, result):
        super().__init__(result)
        self.result = result


class InvalidLoss(ValueError):
    """An objective returned a non-finite or non-numeric loss."""

    def __init__(self, result):
        super().__init__(result)
        self.result = result


class AllTrialsFailed(Exception):
    """Every trial errored or failed; there is no argmin."""


class InvalidAnnotatedParameter(ValueError):
    """fn has a parameter with an unsupported annotation."""
