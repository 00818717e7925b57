"""Progress-reporting callbacks for ``fmin`` (the port's copy of
:mod:`hyperopt_tpu.progress`): a ``tqdm`` bar of trials completed and the
best loss so far, with stdout written through ``tqdm`` so an objective's
prints do not shred the bar.  ``tqdm`` is imported when a bar is opened,
never at import: it is the optional ``progress`` extra.
"""

from __future__ import annotations

import contextlib
import sys

__all__ = ["tqdm_progress_callback", "no_progress_callback", "default_callback"]


class ProgressContext:
    """Handle given to FMinIter: ``update(n, best_loss=...)``."""

    def __init__(self, pbar=None):
        self._pbar = pbar

    def update(self, n=1, best_loss=None):
        if self._pbar is None:
            return
        if best_loss is not None:
            self._pbar.set_postfix_str(f"best loss: {best_loss:.6g}", refresh=False)
        self._pbar.update(n)


class _TqdmWriteProxy:
    """File-like stdout proxy writing through ``tqdm.write``."""

    def __init__(self, stream, tqdm_cls):
        self._stream = stream
        self._tqdm = tqdm_cls

    def write(self, text):
        text = text.rstrip("\n")
        if text:
            self._tqdm.write(text, file=self._stream)

    def flush(self):
        self._stream.flush()

    def __getattr__(self, name):
        return getattr(self._stream, name)


@contextlib.contextmanager
def tqdm_progress_callback(initial, total):
    from tqdm import tqdm

    pbar = tqdm(
        total=total,
        initial=initial,
        ascii=False,
        dynamic_ncols=True,
        unit="trial",
        leave=True,
        file=sys.stderr,
    )
    old_stdout = sys.stdout
    try:
        sys.stdout = _TqdmWriteProxy(old_stdout, tqdm)
        yield ProgressContext(pbar)
    finally:
        sys.stdout = old_stdout
        pbar.close()


@contextlib.contextmanager
def no_progress_callback(initial, total):
    yield ProgressContext(None)


default_callback = tqdm_progress_callback
