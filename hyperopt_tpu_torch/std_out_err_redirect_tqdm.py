"""Redirect stdout/stderr through tqdm.write so prints don't mangle bars.

Reference parity (SURVEY.md §2 #20): ``hyperopt/std_out_err_redirect_tqdm.py``.
"""

import contextlib
import io
import sys

from tqdm import tqdm


class DummyTqdmFile:
    """File-like object that writes through tqdm."""

    file = None

    def __init__(self, file):
        self.file = file

    def write(self, x):
        if len(x.rstrip()) > 0:
            tqdm.write(x, file=self.file, end="")

    def flush(self):
        return getattr(self.file, "flush", lambda: None)()

    def close(self):
        # never close the wrapped real stream: logging handlers that
        # captured this object while redirection was active call close()
        # at interpreter shutdown, and closing sys.__stdout__/__stderr__
        # underneath everyone else would be worse than the leak
        pass

    def isatty(self):
        return getattr(self.file, "isatty", lambda: False)()

    def fileno(self):
        # file-like contract: absence of a fileno is signalled with
        # io.UnsupportedOperation (an OSError), not AttributeError
        fn = getattr(self.file, "fileno", None)
        if fn is None:
            raise io.UnsupportedOperation("fileno")
        return fn()


@contextlib.contextmanager
def std_out_err_redirect_tqdm():
    orig_out_err = sys.stdout, sys.stderr
    try:
        sys.stdout, sys.stderr = map(DummyTqdmFile, orig_out_err)
        yield orig_out_err[0]
    except Exception as exc:
        raise exc
    finally:
        sys.stdout, sys.stderr = orig_out_err
