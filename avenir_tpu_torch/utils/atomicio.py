"""Rename-atomic file writes: a temporary file in the same directory, then
``os.replace`` over the destination, so a crash or a failed serialization
leaves the previous file whole, never a truncated one.

Counterpart of ``avenir_tpu/utils/atomicio.py``. The temporary name
carries the process and the thread, so that concurrent writers of one
file never share it: two attempts of one shard, racing on two threads,
write the same quarantine sidecar.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable


def atomic_write_text(path: str, emit: Callable, mode: str = "w") -> None:
    """Run ``emit(fh)`` against a same-directory temporary file, then
    ``os.replace`` it over ``path``. On any failure the temporary file is
    removed and ``path`` is untouched. ``mode`` opens the temporary file
    (``"wb"`` for binary emitters)."""
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    try:
        with open(tmp, mode) as fh:
            emit(fh)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)


def atomic_json_dump(obj, path: str, **dump_kwargs) -> None:
    """``json.dump`` through :func:`atomic_write_text`: serialization runs
    inside the temporary write, so an object that fails mid-way never
    tears the destination."""
    atomic_write_text(path, lambda fh: json.dump(obj, fh, **dump_kwargs))


def atomic_write_data(path: str, data) -> None:
    """Already serialized ``str`` or ``bytes`` through
    :func:`atomic_write_text`."""
    atomic_write_text(path, lambda fh: fh.write(data),
                      "wb" if isinstance(data, bytes) else "w")
