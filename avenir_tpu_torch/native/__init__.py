"""The native CSV encoder: ``native/avt_io.cpp`` at the repo root, built
with g++ into a shared library beside this module and bound with ctypes.

Counterpart of ``avenir_tpu/native/__init__.py``: the same source, the
same g++ recipe and the same C ABI, but a library of the port's own. Its
name carries a hash of the source's content and the flags
(``_avt_io-<hash>.so``), so a library built from another tree's source is
never loaded, and an edited source rebuilds. Each build writes a temporary
file named by process and thread, then ``os.replace`` puts it in place, so
concurrent builds never see a half-written library.

No Python path stands in for the encoder: a missing compiler, a failed
build or a library that does not load raises :class:`BuildError` with the
compiler's output. (``loader.transform_file`` takes the Python path only
where the C++ path cannot go by design, a delimiter that is not one byte.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from avenir_tpu_torch.obs import runtime

LIB_DIR = Path(__file__).resolve().parent
SRC = LIB_DIR.parent.parent / "native" / "avt_io.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


class BuildError(RuntimeError):
    """g++ is missing, or the encoder failed to build or to load."""


def library_path() -> Path:
    """Where the library built from the current source lives."""
    if not SRC.is_file():
        raise BuildError(f"native encoder source not found: {SRC}")
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return LIB_DIR / f"_avt_io-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the encoder unless this exact build exists; return its
    path."""
    lib = library_path()
    if lib.exists():
        return lib
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise BuildError(f"g++ could not run ({exc}); the native CSV "
                         "encoder of avenir_tpu_torch needs g++") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"g++ failed on {SRC} (exit {proc.returncode}):\n"
                         f"{proc.stderr}")
    os.replace(tmp, lib)
    runtime.record_compile("native_build", time.perf_counter() - t0)
    return lib


_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_ENCODE_ARGS = [ctypes.c_char_p, _I64, ctypes.c_char, _I32,
                ctypes.POINTER(ctypes.c_int8),     # kinds
                ctypes.POINTER(_I32),              # feat_slot
                ctypes.POINTER(ctypes.c_double),   # bucket_width
                ctypes.POINTER(_I64),              # bin_offset
                ctypes.c_char_p,                   # vocab_blob
                ctypes.POINTER(_I32),              # vocab_counts
                _I32, _I32]                        # oov, n_feat
_SIGNATURES = {
    "avt_encode": (_ENCODE_ARGS, _P),
    "avt_encode_parallel": (_ENCODE_ARGS + [_I32], _P),      # + n_threads
    "avt_encode_parallel2": (_ENCODE_ARGS + [_I32, _I32], _P),  # + skip_bad
    "avt_bad_count": ([_P], _I64),
    "avt_bad_fill": ([_P, ctypes.POINTER(_I64)], None),
    "avt_rows": ([_P], _I64),
    "avt_error_msg": ([_P], ctypes.c_char_p),
    "avt_fill": ([_P, ctypes.POINTER(_I32), ctypes.POINTER(ctypes.c_float),
                  ctypes.POINTER(_I32), ctypes.POINTER(_I64)], None),
    "avt_free": ([_P], None),
    "avt_project": ([ctypes.c_char_p, _I64, ctypes.c_char, _I32, _I32,
                     ctypes.POINTER(_I32), _I32, _I32, _I32], _P),
    "avt_project_size": ([_P], _I64),
    "avt_project_error": ([_P], ctypes.c_char_p),
    "avt_project_copy": ([_P, ctypes.c_char_p], None),
    "avt_project_free": ([_P], None),
}


def load() -> ctypes.CDLL:
    """The encoder's library, built on first use and loaded once per
    process, with every function's ``argtypes``/``restype`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
                for name, (argtypes, restype) in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = restype
            except (OSError, AttributeError) as exc:
                raise BuildError(f"{path} does not load: {exc}") from exc
            _lib = lib
        return _lib
