"""Progress reporting for the fmin driver loop.

Reference parity (SURVEY.md §2 #20): ``hyperopt/progress.py`` —
``tqdm_progress_callback`` / ``no_progress_callback``; context managers
yielding an object with ``.update(n)`` and a ``.postfix`` attribute.
"""

import contextlib

from .std_out_err_redirect_tqdm import std_out_err_redirect_tqdm


class _ProgressHandle:
    def __init__(self, pbar=None):
        self._pbar = pbar

    def update(self, n):
        if self._pbar is not None:
            self._pbar.update(n)

    @property
    def postfix(self):
        return getattr(self._pbar, "postfix", None)

    @postfix.setter
    def postfix(self, value):
        if self._pbar is not None:
            self._pbar.set_postfix_str(str(value) if value is not None else "")


@contextlib.contextmanager
def tqdm_progress_callback(initial, total):
    from tqdm import tqdm

    with std_out_err_redirect_tqdm() as orig_stdout:
        with tqdm(
            total=total,
            initial=initial,
            file=orig_stdout,
            dynamic_ncols=True,
            unit="trial",
        ) as pbar:
            yield _ProgressHandle(pbar)


@contextlib.contextmanager
def no_progress_callback(initial, total):
    yield _ProgressHandle(None)


default_callback = tqdm_progress_callback
