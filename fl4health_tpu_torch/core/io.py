"""Host filesystem helpers (counterpart of ``fl4health_tpu/core/io.py``, its
``atomic_write``): a reporter's dump is published whole or not at all, so a
reader that opens it mid-run never sees a truncated file."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w"):
    """Context manager yielding a file handle to a temp sibling of ``path``;
    on clean exit the temp file is atomically renamed over ``path`` (parent
    directories are created), on exception it is removed and the previously
    published file is left untouched."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            yield f
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
